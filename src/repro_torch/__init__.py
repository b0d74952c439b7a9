"""repro_torch — the PyTorch / CUDA port of ``repro`` for one NVIDIA H100.

The module layout mirrors ``src/repro`` so that each port module has one
reference module to be held against: ``repro_torch/ps/runtime.py`` is the
counterpart of ``repro/ps/runtime.py``. The port imports ``torch`` and
numpy, never ``jax`` and nothing of ``repro``; what it needs of a reference
module it keeps as its own copy.

Entry points take an explicit ``device``. They run on ``cuda`` unless the
caller passes ``device="cpu"``; a missing GPU without an explicit ``cpu``
is an error, never a silent fallback (``utils.device.resolve_device``).

Ported so far (see ROADMAP.md for what is still to come):

* the Sync EASGD / Sync SGD parameter-server trainer on the thread
  transport (``ps``), with its fused f64 update kernels written in CUDA
  (``kernels/csrc/elastic_update.cu``);
* the gemma3-4b decoder LM (``models``), with its flash-attention and fused
  cross-entropy kernels, forward and backward, in CUDA
  (``kernels/csrc/flash_attention.cu``, ``kernels/csrc/fused_ce.cu``);
* the packed multi-pod Sync EASGD step (``core.elastic``,
  ``runtime.train``, ``launch.train --mode sync``), with its exchange plan
  (``comm.plan``), compressions, data pipeline, checkpoints and watchdog,
  and the fused momentum-EASGD update ``fused_elastic_update`` in CUDA
  (``kernels/csrc/elastic_update.cu``).
* placement on a ``(pod, data, model)`` mesh of processes over
  ``torch.distributed`` (``launch.mesh``, ``runtime.sharding``,
  ``models.tp``): the multi-pod step, serving and the launcher, with the
  kernels on each rank's local shards; and ``optim``.
"""
