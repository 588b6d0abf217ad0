"""CHStone kernels as stepped torch regions (reference:
``coast_tpu/models/chstone/``).

The CHStone suite is the reference's large-benchmark tier: 12
self-checking kernels built with ``OPT_PASSES=-TMR`` and the target of
the full TMR campaign (BASELINE config 4).  Each module here is the
counterpart of the reference module of the same name; the mips kernel is
``coast_tpu_torch/models/chstone_mips.py`` and the aes kernel
``coast_tpu_torch/models/aes.py``, as in the reference.
"""
