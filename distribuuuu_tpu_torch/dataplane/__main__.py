"""``python -m distribuuuu_tpu_torch.dataplane``: the service, or one worker.

- service (the default): the dispatcher and its pool of decode worker
  processes, configured like every entry point (``--cfg FILE`` and trailing
  ``KEY VALUE`` overrides; ``DATA.*`` and the dataset keys). Prints
  ``dtpu-dataplane: serving at HOST:PORT`` and runs until SIGTERM or SIGINT,
  then stops and reaps every worker. It journals into OUT_DIR's
  ``telemetry.jsonl.part3500`` (a ``dataplane_cache`` rollup every
  ``STATS_EVERY_S``) and, with ``OBS.METRICS_PORT``, serves ``/metrics``.
- worker (``--worker --address HOST:PORT --id wN --threads T``): one
  decode worker, as the service starts it; also what another machine runs
  to join a dispatcher.

The process never initializes the card, not as a fallback nor otherwise:
the cards belong to the trainers this tier feeds. A worker sets PyTorch to
one intra-op thread; its decode threads are its parallelism.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

#: the cadence of the service's dataplane_cache rollups, so a tailing plane
#: sees live gauges
STATS_EVERY_S = 10.0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="python -m distribuuuu_tpu_torch.dataplane", add_help=False,
        description="The dataplane input service: decode in worker processes, serve batches.")
    parser.add_argument("--worker", action="store_true")
    parser.add_argument("--address", default="")
    parser.add_argument("--id", default="w0", dest="worker_id")
    parser.add_argument("--threads", type=int, default=4)
    args, rest = parser.parse_known_args(argv)

    from distribuuuu_tpu_torch.config import load_cfg_fom_args
    from distribuuuu_tpu_torch.logging import setup_logger

    load_cfg_fom_args("The dataplane input service.", argv=rest)
    setup_logger(None)  # stderr only: OUT_DIR's log belongs to the trainer
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())

    if args.worker:
        if not args.address:
            print("--worker requires --address host:port", file=sys.stderr)
            return 2
        import torch

        from distribuuuu_tpu_torch.dataplane.worker import run_worker

        torch.set_num_threads(1)
        run_worker(args.address, args.worker_id, threads=args.threads, stop=stop)
        return 0

    from distribuuuu_tpu_torch.dataplane.service import DataPlaneService

    service = DataPlaneService.from_cfg(worker_argv=rest).start()
    try:
        service.start_obs_plane()
        print(f"dtpu-dataplane: serving at {service.address}", flush=True)
        next_stats = time.monotonic() + STATS_EVERY_S
        while not stop.wait(1.0):  # a timed wait: the signal handler runs between waits
            if time.monotonic() >= next_stats:
                service.journal_stats()
                next_stats += STATS_EVERY_S
    finally:
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
