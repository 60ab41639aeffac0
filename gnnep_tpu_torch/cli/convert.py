"""CLI: convert reference (PyTorch) ensemble artifacts to the checkpoint
schema both packages read, the flags of `gnnep_tpu.cli.convert`:

    python -m gnnep_tpu_torch.cli.convert --reference-dir <ref>/artifacts/ensemble \
        --out-dir artifacts/ensemble --heads 4

Converts scaler_state.pt, conformal.pt, and any model_{i}.pt checkpoints
(heads is the one hyperparameter not recoverable from weight shapes). Host
code, no `--device`: the converted directory serves directly through
`gnnep_tpu_torch.cli.{evaluate,predict,bundle}`.
"""
from __future__ import annotations

import argparse

from ..train.convert import convert_ensemble


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reference-dir", required=True,
                   help="Reference artifacts dir holding scaler_state.pt / "
                        "conformal.pt / model_{i}.pt")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--heads", type=int, default=4,
                   help="Attention heads used in training (not recoverable "
                        "from shapes; reference default 4)")
    p.add_argument("--dropout", type=float, default=0.15)
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    n = convert_ensemble(args.reference_dir, args.out_dir, heads=args.heads,
                         dropout=args.dropout, verbose=not args.quiet)
    if not args.quiet:
        print(f"done ({n} member checkpoint(s))")
    return n


if __name__ == "__main__":
    main()
