"""Train a model: ``python -m distribuuuu_tpu_torch.train_net --cfg FILE [KEY VALUE ...]``.

The JAX CLI's contract (``--cfg`` then trailing overrides). One process a
GPU: several processes (``torchrun --nproc_per_node N -m
distribuuuu_tpu_torch.train_net ...``) join one group, each on
``cuda:LOCAL_RANK``. Runs on the card; ``main(argv, device="cpu")`` runs
on the CPU (the tests' way in). The exit code says how the run ended, as
the JAX CLI's: 0 clean, 143/130 preempted (SIGTERM/SIGINT, an emergency
checkpoint written), 124 hung (the watchdog fired), 117 poisoned
(non-finite steps back to back).
"""

from distribuuuu_tpu_torch import resilience
from distribuuuu_tpu_torch.config import cfg, load_cfg_fom_args
from distribuuuu_tpu_torch.runtime.dist import close_distributed
from distribuuuu_tpu_torch.trainer import train_model


def main(argv=None, device=None) -> None:
    load_cfg_fom_args("Train a classification model.", argv)
    cfg.freeze()
    code, _ = resilience.call_with_poison_exit(lambda: train_model(device))
    if code:
        raise SystemExit(code)
    close_distributed()


if __name__ == "__main__":
    main()
