"""Minimal mmCIF backbone parser (no BioPython dependency).

A numpy copy of the JAX package's ``dataprep/mmcif.py`` (no JAX there, but
the port keeps its own copy).

Parses the ``_atom_site`` loop of an mmCIF file into per-model, per-chain
N/CA/C backbone arrays — the subset of parsing the reference does through
BioPython's MMCIFParser (``prepare_data.py:520-551,853-855``). Handles
multi-model NMR entries, altloc filtering (first altloc wins), and
insertion codes (residues keyed by ``(auth_seq_id, ins_code)`` like
BioPython's ``(hetflag, resseq, icode)`` ids, so 100 and 100A stay
distinct and ordered).
"""

from __future__ import annotations

import gzip
import io
from typing import Optional

import numpy as np

from protein_ensemble_vae_torch.config import AA_3TO1

_BACKBONE = ("N", "CA", "C")

# Extended 3->1 mapping for common non-standard residues (reference
# sequence_from_resnames, prepare_data.py:444-494); unknowns become "X".
AA_3TO1_EXT = {
    **AA_3TO1,
    "HSD": "H", "HSE": "H", "HSP": "H", "HID": "H", "HIE": "H", "HIP": "H",
    "CYX": "C", "CYM": "C",
    "ASH": "D", "GLH": "E",
    "LYN": "K",
    "MSE": "M",
    "SEP": "S", "TPO": "T", "PTR": "Y",
    "MLY": "K", "ALY": "K",
    "HYP": "P",
    "CSO": "C", "CSS": "C",
}


def _tokenize_cif_line(line: str) -> list[str]:
    """Split a CIF data line respecting quoted tokens."""
    out, i, n = [], 0, len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n:
            break
        if line[i] in "'\"":
            q = line[i]
            j = line.find(q, i + 1)
            if j < 0:
                j = n
            out.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            out.append(line[i:j])
            i = j
    return out


def parse_mmcif_backbone(path_or_text: str, is_text: bool = False) -> dict:
    """Parse backbone atoms.

    Returns ``{chain_id: {"models": {model_num: {resseq: {atom: xyz}}},
    "resnames": {resseq: resname}}}``.
    """
    if is_text:
        fh = io.StringIO(path_or_text)
    elif path_or_text.endswith(".gz"):
        fh = io.TextIOWrapper(gzip.open(path_or_text, "rb"))
    else:
        fh = open(path_or_text)

    chains: dict = {}
    header: list[str] = []
    in_loop = False
    collecting = False

    with fh:
        for raw in fh:
            line = raw.rstrip("\n")
            s = line.strip()
            if s == "loop_":
                in_loop = True
                header = []
                collecting = False
                continue
            if in_loop and s.startswith("_"):
                header.append(s.split()[0])
                collecting = header and header[0].startswith("_atom_site.")
                continue
            if in_loop and header:
                if (not s) or s.startswith("#") or s.startswith("_") \
                        or s.startswith("loop_") or s.startswith("data_"):
                    in_loop = s == "loop_"
                    if in_loop:
                        header = []
                    collecting = False
                    continue
                if not collecting:
                    continue
                tokens = _tokenize_cif_line(s)
                if len(tokens) != len(header):
                    continue
                rec = dict(zip(header, tokens))
                if rec.get("_atom_site.group_PDB") != "ATOM":
                    continue
                atom = rec.get("_atom_site.label_atom_id", "")
                if atom not in _BACKBONE:
                    continue
                alt = rec.get("_atom_site.label_alt_id", ".")
                if alt not in (".", "A", "?"):
                    continue
                chain = rec.get("_atom_site.auth_asym_id",
                                rec.get("_atom_site.label_asym_id", "A"))
                icode = rec.get("_atom_site.pdbx_PDB_ins_code", "")
                if icode in ("?", "."):
                    icode = ""
                try:
                    resseq = (int(rec.get("_atom_site.auth_seq_id",
                                          rec.get("_atom_site.label_seq_id"))),
                              icode)
                    model = int(rec.get("_atom_site.pdbx_PDB_model_num", "1"))
                    xyz = np.array([float(rec["_atom_site.Cartn_x"]),
                                    float(rec["_atom_site.Cartn_y"]),
                                    float(rec["_atom_site.Cartn_z"])],
                                   np.float32)
                except (TypeError, ValueError):
                    continue
                resname = rec.get("_atom_site.label_comp_id", "UNK")
                ch = chains.setdefault(chain, {"models": {}, "resnames": {}})
                m = ch["models"].setdefault(model, {})
                r = m.setdefault(resseq, {})
                if atom not in r:   # first altloc wins
                    r[atom] = xyz
                ch["resnames"].setdefault(resseq, resname)
    return chains


def _open_cif(path_or_text: str, is_text: bool):
    if is_text:
        return io.StringIO(path_or_text)
    if path_or_text.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path_or_text, "rb"))
    return open(path_or_text)


def parse_mmcif_categories(path_or_text: str, prefixes: tuple[str, ...],
                           is_text: bool = False) -> dict[str, list[str]]:
    """Generic mmCIF item extractor for the given category prefixes
    (e.g. ``("_struct_ref.", "_exptl.")``).

    Handles both key-value form (``_cat.item value`` / value on the next
    line / semicolon text blocks) and loop form (rows may span lines).
    Returns ``{item_name: [values...]}`` — the subset of parsing the
    reference does through BioPython's MMCIF2Dict (prepare_data.py:581-683).
    """
    out: dict[str, list[str]] = {}

    def want(name: str) -> bool:
        return any(name.startswith(p) for p in prefixes)

    with _open_cif(path_or_text, is_text) as fh:
        lines = iter(fh)
        header: list[str] = []
        row: list[str] = []
        in_loop = False
        pending_key: Optional[str] = None
        for raw in lines:
            line = raw.rstrip("\n")
            s = line.strip()
            if s.startswith(";"):
                # semicolon text block = one token
                block = [s[1:]]
                for raw2 in lines:
                    s2 = raw2.rstrip("\n")
                    if s2.strip() == ";":
                        break
                    block.append(s2)
                tok = "\n".join(block).strip()
                if pending_key is not None:
                    if want(pending_key):
                        out.setdefault(pending_key, []).append(tok)
                    pending_key = None
                elif in_loop and header:
                    row.append(tok)
                    if len(row) == len(header):
                        for hname, v in zip(header, row):
                            if want(hname):
                                out.setdefault(hname, []).append(v)
                        row = []
                continue
            if s == "loop_":
                in_loop = True
                header = []
                row = []
                pending_key = None
                continue
            if not s or s.startswith("#") or s.startswith("data_"):
                in_loop = False
                header = []
                row = []
                continue
            if s.startswith("_"):
                toks = _tokenize_cif_line(s)
                if in_loop and not row:
                    header.append(toks[0])
                    continue
                in_loop = False
                header = []
                if len(toks) >= 2:
                    if want(toks[0]):
                        out.setdefault(toks[0], []).append(toks[1])
                else:
                    pending_key = toks[0]
                continue
            # data line
            if pending_key is not None:
                toks = _tokenize_cif_line(s)
                if toks and want(pending_key):
                    out.setdefault(pending_key, []).append(toks[0])
                pending_key = None
                continue
            if in_loop and header:
                row.extend(_tokenize_cif_line(s))
                if len(row) >= len(header):
                    for hname, v in zip(header, row):
                        if want(hname):
                            out.setdefault(hname, []).append(v)
                    row = []
    return out


def uniprot_accessions(path_or_text: str, is_text: bool = False) -> list[str]:
    """UniProt accessions for the entry from ``_struct_ref``.

    The reference reads ``_struct_ref.db_code`` (prepare_data.py:667-684) —
    but for UniProt rows that is the mnemonic entry *name* (e.g. CSPA_ECOLI);
    the search API wants the *accession* (e.g. P0A9X9), which lives in
    ``_struct_ref.pdbx_db_accession``. We prefer the accession and fall back
    to db_code (documented deviation; fixes dead cross-PDB searches).
    """
    d = parse_mmcif_categories(path_or_text, ("_struct_ref.",), is_text)
    db_names = d.get("_struct_ref.db_name", [])
    accs = d.get("_struct_ref.pdbx_db_accession", [])
    codes = d.get("_struct_ref.db_code", [])
    out = []
    for i, db in enumerate(db_names):
        if str(db).strip().upper() not in ("UNP", "UNIPROT"):
            continue
        for src in (accs, codes):
            v = src[i].strip() if i < len(src) else ""
            if v and v not in ("?", "."):
                out.append(v)
                break
    return sorted(set(out))


def _first_float(d: dict, *keys: str) -> float:
    for k in keys:
        vals = d.get(k)
        if vals:
            v = vals[0]
            if v not in ("?", ".", ""):
                try:
                    return float(v)
                except ValueError:
                    pass
    return float("nan")


def extract_metadata(path_or_text: str, is_text: bool = False) -> dict:
    """Method / resolution / pH / temperature / ligand HET codes (reference
    extract_metadata_mmcif, prepare_data.py:581-625)."""
    d = parse_mmcif_categories(
        path_or_text,
        ("_exptl.", "_refine.", "_em_3d_reconstruction.", "_exptl_crystal.",
         "_diffrn.", "_chem_comp."),
        is_text)
    method = d.get("_exptl.method", [""])
    ligs = []
    for cid, ctype in zip(d.get("_chem_comp.id", []),
                          d.get("_chem_comp.type", [])):
        if cid and cid not in ("HOH", "WAT") and \
                str(ctype).lower().startswith(("non-polymer", "ligand")):
            ligs.append(cid)
    return {
        "method": str(method[0]) if method else "",
        "resolution": _first_float(d, "_refine.ls_d_res_high",
                                   "_em_3d_reconstruction.resolution"),
        "pH": _first_float(d, "_exptl_crystal.pH"),
        "temperature_K": _first_float(d, "_diffrn.ambient_temp",
                                      "_em_3d_reconstruction.temperature"),
        "ligands": "+".join(sorted(set(ligs))) if ligs else "",
    }


def chain_to_arrays(chain: dict, min_models: int = 2
                    ) -> Optional[dict]:
    """Chain dict -> fixed arrays over the union of residues present.

    Returns ``{"coords_n/ca/c": [K, L, 3], "mask": [K, L], "sequence": str,
    "resseqs": [L]}`` — a residue is valid in a model iff all of N/CA/C are
    present (matching the reference's completeness requirement). Residue
    keys are ``(auth_seq_id, ins_code)`` tuples (or bare ints from older
    callers); ``resseqs`` keeps the numeric part.
    """
    models = sorted(chain["models"])
    if len(models) < min_models:
        return None
    resseqs = sorted({r for m in models for r in chain["models"][m]})
    if not resseqs:
        return None
    L, K = len(resseqs), len(models)
    idx = {r: i for i, r in enumerate(resseqs)}
    coords = {a: np.zeros((K, L, 3), np.float32) for a in _BACKBONE}
    mask = np.zeros((K, L), np.float32)
    for k, m in enumerate(models):
        for r, atoms in chain["models"][m].items():
            if all(a in atoms for a in _BACKBONE):
                i = idx[r]
                mask[k, i] = 1.0
                for a in _BACKBONE:
                    coords[a][k, i] = atoms[a]
    sequence = "".join(
        AA_3TO1_EXT.get(str(chain["resnames"].get(r, "")).strip().upper(), "X")
        for r in resseqs)
    nums = [r[0] if isinstance(r, tuple) else r for r in resseqs]
    return dict(coords_n=coords["N"], coords_ca=coords["CA"],
                coords_c=coords["C"], mask=mask, sequence=sequence,
                resseqs=np.array(nums, np.int32))
