"""The distributed layer on ``torch.distributed``.

- ``mesh``         — the (dm, seq) mesh of process-group ranks
- ``distributed``  — the process group (NCCL on the card, gloo on the CPU)
- ``dist_fft``     — the sequence-sharded four-step FFT over all-to-all
- ``dm_grid``      — DM trials over the dm axis
- ``segment_dist`` — the whole segment step sharded over the mesh
"""

from srtb_tpu_torch.parallel import dist_fft, mesh  # noqa: F401
