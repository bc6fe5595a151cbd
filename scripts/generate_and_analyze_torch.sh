#!/usr/bin/env bash
# Pipeline orchestration of the PyTorch port: generate -> analyze -> validate
# -> inspect params, through the port's CLIs on the card. The port's
# counterpart of scripts/generate_and_analyze.sh.
#
# Usage: ./scripts/generate_and_analyze_torch.sh <checkpoint_dir> <manifest_csv> [num_samples] [outdir]
# Env: REFINE_STEPS (default 150; 0 disables the geometric refinement),
#      REFINE_MODE (default cartesian; torsion | polish), DEVICE (default cuda)
set -euo pipefail

CKPT=${1:?usage: generate_and_analyze_torch.sh <checkpoint> <manifest> [n] [outdir]}
MANIFEST=${2:?need manifest csv}
NUM=${3:-10}
OUTDIR=${4:-generated_ensembles}
REFINE=${REFINE_STEPS:-150}
MODE=${REFINE_MODE:-cartesian}
DEV=${DEVICE:-cuda}
PKG=protein_ensemble_vae_torch
export PYTHONPATH="$(cd "$(dirname "$0")/.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"

echo "== 1/4 generate (refine_steps=$REFINE, refine_mode=$MODE, device=$DEV) =="
python -m $PKG.cli.generate \
  --checkpoint "$CKPT" --manifest "$MANIFEST" \
  --output_dir "$OUTDIR" --num_samples "$NUM" --refine_steps "$REFINE" \
  --refine_mode "$MODE" --device "$DEV"

echo "== 2/4 analyze =="
python -m $PKG.cli.analyze --pdb_dir "$OUTDIR" --device "$DEV"

echo "== 3/4 validate (first structure) =="
FIRST=$(ls "$OUTDIR"/*_ensemble.pdb | head -1)
BASE=${FIRST%_ensemble.pdb}
python -m $PKG.cli.validate \
  --pred "${BASE}_reconstruction.pdb" --true "${BASE}_true.pdb" \
  --ensemble "$FIRST" --output "$OUTDIR/validation_report.txt" --device "$DEV" || true

echo "== 4/4 parameters =="
python -m $PKG.viz.parameters \
  --checkpoint "$CKPT" --output_dir "$OUTDIR/parameter_analysis" --device "$DEV" || \
  echo "(parameter inspection skipped)"

echo "done: $OUTDIR"
