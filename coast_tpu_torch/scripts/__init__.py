"""The reliability studies of the reference's ``scripts/``, on torch.

Each module keeps the reference script's file name, flags, defaults,
JSON keys and exit rules, and runs as ``python -m
coast_tpu_torch.scripts.<name>``:

- :mod:`.mwtf_report`: the MWTF table (error-rate improvement over
  runtime cost) and, with ``--model-sweep``, the fault-model degradation
  study;
- :mod:`.fidelity_study`: checks C1-C4 of the outcome distribution on
  matrixMultiply under TMR;
- :mod:`.classification_parity`: per-run codes of one seeded schedule on
  the CPU and on the card;
- :mod:`.train_campaign`: the four protected-training campaigns and
  their acceptance bars;
- :mod:`.c_fuzz_sweep`: the resumable record of the gcc-differential
  C fuzz;
- ``zero_to_aha.sh``: the one-command workflow from a C source.

Every study runs on the card unless the caller asks for the CPU
(``--cpu`` or ``-d cpu``), and fails where there is no card.  Records go
where ``--out`` points, by default under ``build/studies/`` of the
checkout; each carries a ``device`` block (:func:`.common.device_block`)
in place of the reference's ``backend``.
"""
