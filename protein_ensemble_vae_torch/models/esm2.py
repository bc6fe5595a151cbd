"""ESM-2 as a frozen PyTorch forward (counterpart of the JAX package's
``models/esm2.py``).

The VAE is conditioned on per-residue ESM-2 (t33, 650M) layer-33
embeddings. ``ESM2`` computes what the JAX package's ``esm2_forward``
computes: token embedding with ESM's token-dropout rescale, pre-LN
transformer blocks with rotary position embeddings on q/k (the query
scaled by head_dim^-0.5 *before* rotary, the ESM convention), exact-erf
GELU, and the final LayerNorm whose output is the "layer 33"
representation. Attention is written out as plain tensor ops, the softmax
in fp32.

Precision: ``ESM2Embedder`` calls ``set_full_fp32()``, so on the GPU every
product (the GEMMs and both attention products) runs in full fp32 on the
CUDA cores, not in TF32 on the tensor cores.

Weights come from a HuggingFace ``EsmModel`` / ``EsmForMaskedLM`` state
dict (``convert_hf_state_dict``) or from the JAX package's params tree
(``models/bridge.esm2_params_from_jax``); ``init_hf_`` fills a model with
seeded random weights drawn as HF initialises them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from protein_ensemble_vae_torch.ops.routing import resolve_device, set_full_fp32

# The ESM alphabet (fair-esm `proteinseq_toks` prepended/appended with the
# special tokens): token ids match both fair-esm and the HF EsmTokenizer.
ESM2_TOKENS = (
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
)
ESM2_TOKEN_TO_ID = {t: i for i, t in enumerate(ESM2_TOKENS)}
CLS_ID, PAD_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
MASK_ID = ESM2_TOKEN_TO_ID["<mask>"]


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    """Defaults are esm2_t33_650M_UR50D."""

    vocab_size: int = 33
    hidden: int = 1280
    num_layers: int = 33
    num_heads: int = 20
    intermediate: int = 5120
    layer_norm_eps: float = 1e-5
    token_dropout: bool = True
    max_tokens: int = 1022          # RESIDUE cap; +2 cls/eos tokens fit
                                    # ESM-2's 1026 positions


def tokenize(sequence: str) -> np.ndarray:
    """AA string -> token ids with <cls>/<eos> framing (no padding)."""
    ids = [CLS_ID]
    ids += [ESM2_TOKEN_TO_ID.get(aa, UNK_ID) for aa in sequence.upper()]
    ids.append(EOS_ID)
    return np.asarray(ids, np.int32)


def _rotary_cos_sin(T: int, head_dim: int, device) -> tuple[Tensor, Tensor]:
    inv_freq = 1.0 / (10000 ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=device) / head_dim))
    t = torch.arange(T, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                     # [T, hd/2]
    emb = torch.cat([freqs, freqs], dim=-1)              # [T, hd]
    return emb.cos(), emb.sin()


def _rotate_half(x: Tensor) -> Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


class ESM2Layer(nn.Module):
    """One pre-LN block: self-attention with rotary q/k, then the FFN."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        D, F_ = cfg.hidden, cfg.intermediate
        self.num_heads = cfg.num_heads
        self.attn_ln = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.q, self.k, self.v = nn.Linear(D, D), nn.Linear(D, D), nn.Linear(D, D)
        self.attn_out = nn.Linear(D, D)
        self.ffn_ln = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.fc1, self.fc2 = nn.Linear(D, F_), nn.Linear(F_, D)

    def forward(self, x: Tensor, cos: Tensor, sin: Tensor, bias: Tensor) -> Tensor:
        B, T, D = x.shape
        H = self.num_heads
        hd = D // H

        def split_heads(t: Tensor) -> Tensor:
            return t.reshape(B, T, H, hd).transpose(1, 2)      # [B, H, T, hd]

        h = self.attn_ln(x)
        q = split_heads(self.q(h)) * (hd ** -0.5)
        k = split_heads(self.k(h))
        v = split_heads(self.v(h))
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        logits = torch.matmul(q, k.transpose(-1, -2)) + bias
        probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
        x = x + self.attn_out(ctx)
        h = F.gelu(self.fc1(self.ffn_ln(x)), approximate="none")
        return x + self.fc2(h)


class ESM2(nn.Module):
    """Frozen forward: tokens [B, T] -> last hidden states [B, T, D]
    (== fair-esm representations[num_layers], HF last_hidden_state)."""

    def __init__(self, config: Optional[ESM2Config] = None):
        super().__init__()
        self.config = cfg = config or ESM2Config()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.layers = nn.ModuleList(ESM2Layer(cfg) for _ in range(cfg.num_layers))
        self.final_ln = nn.LayerNorm(cfg.hidden, eps=cfg.layer_norm_eps)

    def forward(self, tokens: Tensor,
                attention_mask: Optional[Tensor] = None) -> Tensor:
        cfg = self.config
        if attention_mask is None:
            attention_mask = tokens != PAD_ID
        amask = attention_mask.float()
        x = self.word_embeddings(tokens)                   # [B, T, D]
        if cfg.token_dropout:
            # mask-dropout rescale (HF EsmEmbeddings.forward): zero <mask>
            # embeddings, scale by (1 - 0.15*0.8) / (1 - observed mask
            # share), the share taken over the unpadded length.
            is_mask = tokens == MASK_ID
            x = x.masked_fill(is_mask[..., None], 0.0)
            observed = is_mask.float().sum(-1) / amask.sum(-1)
            x = x * ((1.0 - 0.12) / (1.0 - observed))[:, None, None]
        x = x * amask[..., None]

        T = x.shape[1]
        cos, sin = _rotary_cos_sin(T, cfg.hidden // cfg.num_heads, x.device)
        # additive attention bias: the most negative fp32 at padded keys
        bias = (1.0 - amask[:, None, None, :]) * torch.finfo(torch.float32).min
        for layer in self.layers:
            x = layer(x, cos, sin, bias)
        return self.final_ln(x)


@torch.no_grad()
def init_hf_(model: ESM2, generator: torch.Generator) -> ESM2:
    """Seeded random weights drawn as HF's ``EsmPreTrainedModel`` draws
    them: every Linear weight and the embedding from normal(0, 0.02), zero
    biases, LayerNorm weight 1 and bias 0, the <pad> embedding row zero."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.weight.normal_(0.0, 0.02, generator=generator)
        if isinstance(m, nn.Linear):
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    model.word_embeddings.weight[PAD_ID].zero_()
    return model


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_HF_LAYER_KEYS = {
    "attn_ln": "attention.LayerNorm",
    "q": "attention.self.query",
    "k": "attention.self.key",
    "v": "attention.self.value",
    "attn_out": "attention.output.dense",
    "ffn_ln": "LayerNorm",
    "fc1": "intermediate.dense",
    "fc2": "output.dense",
}


def _t(v) -> Tensor:
    if isinstance(v, Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(v, dtype=np.float32))


def convert_hf_state_dict(sd: Mapping) -> tuple[dict[str, Tensor], ESM2Config]:
    """HF EsmModel / EsmForMaskedLM state dict -> (``ESM2`` state_dict,
    config).

    Accepts keys with or without the ``esm.`` prefix (EsmForMaskedLM nests
    the encoder under ``esm.``). HF's Linear and LayerNorm layouts are the
    port's own, so each tensor only changes its name.
    """
    if any(k.startswith("esm.") for k in sd):
        sd = {k[len("esm."):]: v for k, v in sd.items() if k.startswith("esm.")}

    out = {"word_embeddings.weight": _t(sd["embeddings.word_embeddings.weight"])}
    n = 0
    while f"encoder.layer.{n}.attention.self.query.weight" in sd:
        for ours, theirs in _HF_LAYER_KEYS.items():
            for leaf in ("weight", "bias"):
                out[f"layers.{n}.{ours}.{leaf}"] = _t(
                    sd[f"encoder.layer.{n}.{theirs}.{leaf}"])
        n += 1
    for leaf in ("weight", "bias"):
        out[f"final_ln.{leaf}"] = _t(sd[f"encoder.emb_layer_norm_after.{leaf}"])
    vocab, hidden = out["word_embeddings.weight"].shape
    cfg = ESM2Config(
        vocab_size=vocab, hidden=hidden, num_layers=n,
        num_heads=_infer_num_heads(sd, hidden),
        intermediate=out["layers.0.fc1.weight"].shape[0] if n else 4 * hidden)
    return out, cfg


def _infer_num_heads(sd: Mapping, hidden: int) -> int:
    """Head count from the state dict itself: the rotary ``inv_freq`` buffer
    has length head_dim/2, so num_heads = hidden / (2·len). Falls back to
    the ESM-2 family table (every size t6-t33 uses 20 heads; t36 uses 40)
    for dicts saved without buffers."""
    for k, v in sd.items():
        if k.endswith("rotary_embeddings.inv_freq"):
            head_dim = 2 * int(np.shape(v)[0])
            if head_dim > 0 and hidden % head_dim == 0:
                return hidden // head_dim
            break
    return 40 if hidden >= 2560 else 20


def load_hf_esm2(name_or_path: str = "facebook/esm2_t33_650M_UR50D"
                 ) -> tuple[dict[str, Tensor], ESM2Config]:
    """A HF checkpoint (hub cache or local path) -> (``ESM2`` state_dict,
    config). Needs ``transformers`` and the checkpoint; raises
    ``RuntimeError`` when either is missing."""
    try:
        from transformers import EsmModel
    except ImportError as e:
        raise RuntimeError("load_hf_esm2 needs the transformers package") from e
    try:
        model = EsmModel.from_pretrained(name_or_path, add_pooling_layer=False)
    except (OSError, ValueError) as e:
        raise RuntimeError(f"could not load the ESM-2 checkpoint "
                           f"{name_or_path!r}: {e}") from e
    sd, cfg = convert_hf_state_dict(model.state_dict())
    return sd, dataclasses.replace(cfg, num_heads=model.config.num_attention_heads)


# ---------------------------------------------------------------------------
# Embedding extraction (the dataprep entry point)
# ---------------------------------------------------------------------------

class ESM2Embedder:
    """Per-sequence embedding extraction with length bucketing, on
    ``device`` (default "cuda"; a CUDA device without a GPU raises).

    Sequences are padded to a power-of-two bucket (32 tokens, doubling),
    as the JAX package pads them to bound its compiled shapes, so the two
    run the same padded lengths. ``params`` is an ``ESM2`` state_dict.
    """

    def __init__(self, params: Mapping[str, Tensor], config: ESM2Config,
                 device: str = "cuda"):
        self.config = config
        self.device = resolve_device(device)
        with torch.device("meta"):
            model = ESM2(config)
        model = model.to_empty(device=self.device)
        model.load_state_dict(params)
        self.model = model.eval().requires_grad_(False)

    @staticmethod
    def _bucket(n: int) -> int:
        b = 32
        while b < n:
            b *= 2
        return b

    def embed(self, sequence: str) -> np.ndarray:
        """[L, D] per-residue layer-N representation, CLS/EOS stripped."""
        # max_tokens is the RESIDUE cap: tokens = residues + cls/eos
        if len(sequence) > self.config.max_tokens:
            raise ValueError(f"sequence length {len(sequence)} exceeds the "
                             f"{self.config.max_tokens} residue cap")
        set_full_fp32()
        ids = tokenize(sequence)
        toks = np.full((1, self._bucket(len(ids))), PAD_ID, np.int64)
        toks[0, :len(ids)] = ids
        toks = torch.from_numpy(toks).to(self.device)
        with torch.inference_mode():
            reps = self.model(toks, toks != PAD_ID)
        return reps[0, 1:len(ids) - 1].float().cpu().numpy()   # strip cls/eos
