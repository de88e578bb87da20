"""CLI of the port: the counterpart of the repository's main.py.

    python -m dreamscene_tpu_torch --object --config configs/objects/sample.yaml \
        [--device cuda|cpu] [--exp-root experiments] [a.b=c ...]

Defaults <- YAML file <- dotlist overrides (utils/config.load_config).
`--object` trains one object (ObjectTrainer.train); the scene pipeline is
not ported yet (ROADMAP queue A, the scene path). The trainer runs on the
card unless `--device cpu` is given.
"""

import argparse
import logging
import sys

from dreamscene_tpu_torch.utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m dreamscene_tpu_torch",
                                     description="DreamScene, PyTorch/CUDA port")
    parser.add_argument("--object", action="store_true", help="single-object generation mode")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--exp-root", default="experiments",
                        help="directory that holds the experiment folders")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides, e.g. seed=1")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    if not args.object:
        raise NotImplementedError(
            "scene generation is not ported yet: ROADMAP queue A, the scene path "
            "(pass --object for single-object generation)")
    from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer

    cfg = load_config(args.config, args.overrides, object_mode=True)
    ObjectTrainer(cfg, exp_root=args.exp_root, device=args.device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
