"""Evaluate a checkpoint: ``python -m distribuuuu_tpu_torch.test_net --cfg FILE MODEL.WEIGHTS CKPT [KEY VALUE ...]``.

Prints ``* Acc@1 ... Acc@5 ...`` for the val loader. Runs on the card.
"""

from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args
from distribuuuu_tpu_torch.runtime.dist import close_distributed
from distribuuuu_tpu_torch.trainer import test_model


def main(argv=None) -> None:
    load_cfg_fom_args("Test a trained classification model.", argv)
    cfg.freeze()
    test_model()
    close_distributed()


if __name__ == "__main__":
    main()
