"""The dataplane: decode off the training process (``DATA.SERVICE``).

A port of ``distribuuuu_tpu/dataplane``, with its wire format:

- ``dispatcher.Dispatcher`` owns the seed- and epoch-keyed permutation
  (``data.loader.shard_indices``, the function local decode runs, so the
  sample stream is bitwise the local one) and leases batches to decode
  workers with visit-once accounting and a decoded-batch cache;
- ``worker.run_worker`` leases a batch, decodes it with
  ``HostDataLoader.decode_batch`` and pushes the frame back;
- ``client.ServiceLoader`` is the trainer's loader: it receives finished
  batches in a producer thread straight into pinned tensors, and falls
  back to local decode when the dispatcher dies (``DATA.FALLBACK``);
- ``service.DataPlaneService`` is the dispatcher plus worker processes,
  started by ``python -m distribuuuu_tpu_torch.dataplane``.

The fault injector reaches the workers' loaders and the client's batch
requests, as in the JAX package. The service journals its ``dataplane_*``
records into OUT_DIR's ``.part3500`` and serves ``/metrics`` on
``OBS.METRICS_PORT``; a client's fallback lands in the trainer's journal.
Not ported (ROADMAP Queue 1 item 13): ``DATA.SERVICE fleet`` and
``AGENT.DATAPLANE``.
"""

from distribuuuu_tpu_torch.dataplane.client import ServiceLoader
from distribuuuu_tpu_torch.dataplane.dispatcher import BatchCache, Dispatcher, LeaseTable
from distribuuuu_tpu_torch.dataplane.service import DataPlaneService

__all__ = ["BatchCache", "DataPlaneService", "Dispatcher", "LeaseTable", "ServiceLoader"]
