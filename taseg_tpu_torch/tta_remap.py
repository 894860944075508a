"""Label-id remap tool for prediction directories:
`python -m taseg_tpu_torch.tta_remap --path DIR [--direction D]`.

Counterpart of the JAX package's `tta_remap.py` (reference tta_remap.py,
LUT build :96-101, remap loop :137-156): converts every
`sequences/*/predictions/*.label` under DIR between train ids and
SemanticKITTI raw ids — raw ids for benchmark submissions, train ids for
the pseudo-mask directories of FSA training.
"""

from __future__ import annotations

import argparse

from .utils.submission import remap_label_files


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="remap prediction .label files")
    p.add_argument("--path", required=True,
                   help="root holding sequences/*/predictions/*.label")
    p.add_argument("--direction", default="train_to_raw",
                   choices=["train_to_raw", "raw_to_train"])
    p.add_argument("--no_inplace", action="store_true")
    args = p.parse_args(argv)
    n = remap_label_files(
        args.path, direction=args.direction, inplace=not args.no_inplace
    )
    print(f"remapped {n} label files under {args.path}")


if __name__ == "__main__":
    main()
