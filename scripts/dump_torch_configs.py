#!/usr/bin/env python
"""Write the PyTorch package's config JSONs from the JAX ``configs/`` package.

One file per experiment name: every module of ``configs/`` (except the
ablation factory) and every fixed ablation of ``configs/ablations.py``,
each written by ``ExperimentConfig.dump``.  This is a maintainer tool and
imports JAX; ``groomed_nms_torch`` itself only reads the files.

    python scripts/dump_torch_configs.py [--out groomed_nms_torch/configs]
"""

import argparse
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config_names():
    import configs
    from configs import ablations
    mods = [m.name for m in pkgutil.iter_modules(configs.__path__)
            if m.name != "ablations"]
    return sorted(mods + [f"groomed_nms_{k}" for k in ablations.ALL])


def dump_all(out_dir):
    from groomed_nms_tpu.config import load_config
    os.makedirs(out_dir, exist_ok=True)
    names = config_names()
    for name in names:
        load_config(name).dump(os.path.join(out_dir, f"{name}.json"))
    return names


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "groomed_nms_torch",
                                                  "configs"))
    args = ap.parse_args()
    names = dump_all(args.out)
    print(f"wrote {len(names)} configs to {args.out}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
