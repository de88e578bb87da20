"""CLI of the port: the counterpart of the repository's main.py.

    python -m dreamscene_tpu_torch [--object] --config CONFIG.yaml \
        [--device cuda|cpu] [--exp-root experiments] [--env-density 1.0] [a.b=c ...]

Defaults <- YAML file <- dotlist overrides (utils/config.load_config).
`--object` trains one object (ObjectTrainer.train); without it the scene
pipeline runs (SceneTrainer.train: the scene's objects, then the three
scene stages), as main.py does. `--env-density` (< 1) scales the env and
floor init clouds down, for small runs. The trainer runs on the card unless
`--device cpu` is given.

Under torchrun the runtime comes up first (parallel/distributed.py), as
main.py's does, and each rank trains on its own device:

    torchrun --nproc-per-node 4 -m dreamscene_tpu_torch --config C.yaml \
        parallelParams.dp=2 parallelParams.tp=2
"""

import argparse
import logging
import sys

from dreamscene_tpu_torch.parallel.distributed import initialize_runtime
from dreamscene_tpu_torch.utils.config import load_config


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m dreamscene_tpu_torch",
                                     description="DreamScene, PyTorch/CUDA port")
    parser.add_argument("--object", action="store_true", help="single-object generation mode")
    parser.add_argument("--config", required=True, help="YAML config path")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--exp-root", default="experiments",
                        help="directory that holds the experiment folders")
    parser.add_argument("--env-density", type=float, default=1.0,
                        help="scene mode: scale of the env/floor init point counts")
    parser.add_argument("overrides", nargs="*", help="dotlist overrides, e.g. seed=1")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    # the multi-process runtime (a no-op for one process), before any device use
    device = initialize_runtime(args.device)
    cfg = load_config(args.config, args.overrides, object_mode=args.object)
    if args.object:
        from dreamscene_tpu_torch.training.object_trainer import ObjectTrainer

        ObjectTrainer(cfg, exp_root=args.exp_root, device=device).train()
    else:
        from dreamscene_tpu_torch.training.scene_trainer import SceneTrainer

        SceneTrainer(cfg, exp_root=args.exp_root, device=device,
                     env_density=args.env_density).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
