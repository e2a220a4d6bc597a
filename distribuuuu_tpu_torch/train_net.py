"""Train a model: ``python -m distribuuuu_tpu_torch.train_net --cfg FILE [KEY VALUE ...]``.

The JAX CLI's contract (``--cfg`` then trailing overrides). One process a
GPU: several processes (``torchrun --nproc_per_node N -m
distribuuuu_tpu_torch.train_net ...``) join one group, each on
``cuda:LOCAL_RANK``. Runs on the card; there is no CPU option here (the
tests call ``trainer.train_model(device="cpu")``).
"""

from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args
from distribuuuu_tpu_torch.trainer import train_model


def main(argv=None) -> None:
    load_cfg_fom_args("Train a classification model.", argv)
    cfg.freeze()
    train_model()


if __name__ == "__main__":
    main()
