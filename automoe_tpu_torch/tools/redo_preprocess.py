"""Cache invalidation (port of automoe_tpu/tools/redo_preprocess.py):
remove preprocessed cache directories so a pipeline re-runs from raw data
(parity with reference scripts/redo_preprocess.py).

    python -m automoe_tpu_torch.tools.redo_preprocess {bdd100k,carla,nuscenes,all}...
        [--base DIR] [--dry-run]
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

DEFAULT_ROOTS = {
    "bdd100k": "datasets/bdd100k/preprocessed",
    "nuscenes": "datasets/nuscenes/preprocessed",
    "carla": "datasets/carla/preprocessed",
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument(
        "datasets", nargs="+", choices=sorted(DEFAULT_ROOTS) + ["all"],
    )
    p.add_argument("--base", default=".", help="repo/dataset base dir")
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)

    targets = sorted(DEFAULT_ROOTS) if "all" in args.datasets else args.datasets
    for name in targets:
        path = Path(args.base) / DEFAULT_ROOTS[name]
        if not path.exists():
            print(f"{name}: nothing at {path}")
            continue
        if args.dry_run:
            print(f"{name}: would remove {path}")
        else:
            shutil.rmtree(path)
            print(f"{name}: removed {path}")


if __name__ == "__main__":
    main()
