#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (coast_tpu_torch) on one NVIDIA card.

Run it with one visible CUDA card, from any directory:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi), the Python, torch and
     CUDA versions;
  2. build every kernel from coast_tpu_torch/csrc with nvcc (sm_90a);
  3. K1 (the vote kernel) against its plain PyTorch version on the card:
     seeded replica sets, n in {2, 3}, int32 and float32 with +-0 and NaN,
     several widths and the per-row window form; grouped launches
     (``vote_sites``) of mixed widths (1 to 1048579), dtypes, windows and
     DWC flags-only checks; then the main path's shapes for TMR and DWC
     (boundary vote and store-slice window at the campaign's window
     starts).  Voted words and flags must be bit-equal.  Then its time at
     those shapes beside its bound (bytes / 3.35 TB/s) and the plain
     version's time, and at the grouped shapes of the engine's sync points
     (the 9x9 pre-step, commit and boundary groups at batch 4096, the
     matrixMultiply1024 boundary group at batch 128): per call (CUDA
     events) and device only (torch.profiler), beside the same sites as
     groups of one (one launch a leaf, the per-leaf form);
  4. the main path: matrixMultiply1024 under TMR and DWC on the card -- a
     clean fault-free record, then a 1024-injection campaign each, which
     must go through the kernel (launch count > 0);
  5. the first 8 rows of each schedule again on the CPU (plain voters):
     records equal outside the rows whose f32 rounding order may differ;
  6. matrixMultiply (9x9) TMR, 16384 injections;
  7. the fused engine (fuse_step=True) and K2, the fused commit kernel:
     (a) K2 against its plain version on the card, bit-equal: seeded
         replica sets, n in {2, 3}, int32 and float32 with +-0, NaN and
         subnormals, no mask and masks with several flipped words a row,
         widths 1 to 1048579, and the fused path's shapes ([4096, 3, 81]
         results, [4096, 3, 1] scalars, [4096, 3, 13] crc16 msg); grouped
         launches (``commit_sites``) of mixed widths, dtypes and masks;
         then its time at [128, 3, 1048576] f32 and [4096, 3, 81] int32
         beside its bytes bound, the plain version's time and the time of
         what it replaces (K1 + the materialised repair), and at the fused
         9x9 pre-step and commit groups, per call and device only, beside
         the groups of one;
     (b) the fused path: matrixMultiply and crc16 under TMR and DWC, 16384
         injections at batch 4096, five pairs of unfused and fused runs
         in alternating order; records equal on every row, K1 and K2
         launched exactly once per sync point (per loop trip: mm TMR 3 K1
         unfused, 2 K2 fused; and one K1 a batch at the boundary);
     (c) the float gate: matrixMultiply1024 under fuse_step=True keeps the
         unfused program;
  8. the device generator (``inject/device_gen.py``) on the card, bit-equal
     to the host ``generate()`` for single, multibit(k=4),
     cluster(span=4,k=3) and burst(window=8,rate=0.5) on the 9x9 and
     matrixMultiply1024 TMR maps, 65,536 rows at a nonzero offset;
  9. matrixMultiply TMR, 10^6 injections at batch 65,536, dense then
     sparse (``collect="sparse"``): counts, interesting rows and their
     columns equal; rates, transfer bytes and interesting rows of each;
 10. matrixMultiply1024 TMR and DWC sparse, 1024 injections at batch 128,
     equal to phase 4's dense runs (and the first interesting rows rerun
     from their sites), then multibit(k=2) under TMR, 512 dense and
     sparse; rates, peak memory and transfer bytes;
 11. flip groups through both engines: matrixMultiply and crc16 under TMR
     and DWC with multibit(k=4), cluster(span=4,k=3) and
     burst(window=8,rate=0.5), 16,384 injections at batch 4096, unfused
     and fused, dense and sparse: the four records equal;
 12. a sparse campaign with ``sparse_capacity=1`` (every batch falls back
     to a dense fetch) equal to dense;
 13. where a sparse batch's time goes (CUDA events, 65,536 rows): the
     device generator against the host ``generate()`` and upload, the
     device accounting, the sparse fetch against the dense fetch;
 14. the supervisor CLI (``python -m coast_tpu_torch.inject.supervisor``,
     each run a process of its own, working files under ``build/``),
     killed and resumed: matrixMultiply TMR dense with a streamed ndjson
     log, and crc16 DWC fused sparse multibit(k=4) with a json log,
     32,768 injections at batch 4096, each once uninterrupted and once
     killed with SIGKILL after 4 journaled batches, then ``--resume``:
     the same summary counts and per-injection log lines, and exactly
     8 batch records;
 15. out-of-memory degradation: matrixMultiply1024 TMR, 256 injections at
     batch 2048 (too large for the card), ``--max-retries 3``: a real
     CUDA out-of-memory error halves the batch until it fits, the journal
     holds the geometry records, and the rows equal a batch-128 run
     outside the f32 exemption; the batch it settled on and the process's
     peak memory;
 16. the watchdog: phase 14's first campaign with ``--collect-timeout
     1e-6 --max-retries 1`` exits non-zero with CampaignWedgedError and an
     intact journal; ``--resume`` without the timeout equals phase 14's
     uninterrupted run;
 17. what durability costs: phase 9's 10^6 campaigns, dense and sparse,
     with a journal and a streamed ndjson log (dense rows formatted by
     the native encoder) through the runner and then through the CLI;
     each rate beside phase 9's and beside the rate to the log's finish
     that the Python formatter gave (``PERF.md``), the journal's and the
     log's bytes
     (no target); then phase 9's dense 10^6 rows through the Python
     formatter and the native encoder on the host: each time, the same
     bytes;
 19. the BASELINE regions (run before phase 18): aes, sha256, quicksort
     and the CHStone suite under TMR, and quicksort under DWC, 1024
     injections at batch 1024, seed 1, unfused and fused: fused = unfused
     on every row, K1 and K2 launched exactly their per-trip counts (a
     CPU twin counts one trip's and one boundary's calls) times the loop
     trips, and the first 64 rows rerun on the CPU equal on every
     column; then chstone_jpeg TMR through the supervisor CLI, with and
     without ``-pallasVoters``: the runner's records on the CLI's default
     section, the same K1 launches; each case's inj/s and wall;
 20. the rest of the registry (run before phase 18), as phase 19:
     trivial, helloWorld, simpleTMR, crazyCF, cache_test, schedule2,
     simd, towersOfHanoi, whetstone and scalarize under TMR,
     towersOfHanoi and scalarize under DWC, towersOfHanoi under
     ``-protectStack -noStoreDataSync``; the CPU rerun equal outside the
     float regions' declared exemptions (``order_sensitive``); then
     towersOfHanoi through the supervisor CLI with ``-TMR -protectStack
     -s stack``: the runner's counts and log rows;
 21. BASELINE config 5, CFCSS stacked with TMR (run before phase 18):
     matrixMultiply1024 under TMR+CFCSS, 512 injections at batch 128,
     seed 1, dense, every section (K1 at the flagship shape, launched its
     per-trip count a loop trip; 16 rows against the CPU outside the f32
     exemption); matrixMultiply, crc16, chstone_mips and crazyCF under
     TMR+CFCSS as phase 19 (4096 injections at 4096, unfused and fused, K1/K2
     launches a trip, 64 rows against the CPU); a ``sections=["cfcss"]``
     campaign on matrixMultiply: due_abort > 0, no SDC, 64 rows against
     the CPU;
 22. function scope and scheduling (run before phase 18): nestedCalls
     under each of the seven scope classes, TMR and DWC, and rtos_app
     under its canonical config (``rtos/functions.config`` plus
     ``rtos/Makefile``'s lists), TMR and DWC, as phase 19, with the K1
     launches of the call-boundary votes a trip; ``-s`` (segmented)
     against ``-i`` on matrixMultiply and crc16 TMR: equal records; then
     ``-f matrixMultiply -O -TMR -CFCSS -s icache`` through the supervisor
     CLI on the card and on the host: the same summary;
 23. the preemptive RTOS kernel targets (run before phase 18): rtos_mm
     and rtos_kUser under their canonical config (``rtos/Makefile``'s
     lists plus ``rtos/kernel.config``), TMR and DWC: fault-free rows
     clean unfused and fused; 8,192 injections at batch 4096, seed 42,
     as phase 19 (fused = unfused, sparse = dense, K1/K2 launches a trip,
     64 rows against the CPU), each with DUE_STACK_OVERFLOW and
     DUE_ASSERT rows, its counts rolled up over ``rtos_sections``; the
     reference's recorded canonical campaign
     (``artifacts/rtos_campaign.json``, read as data) rerun on the card
     with equal counts; ``-f rtos_mm -O '-TMR <canonical>' -s stack``
     through the supervisor CLI against the runner;
 24. the protected training step (run before phase 18): train_mlp and
     train_mlp_adam, the card's golden against the host's (losses within
     1e-5, weights bit-equal), fault-free rows success at batch 1 and
     4096 under unprotected, DWC, TMR and selective xMR; 16,384
     injections at batch 4096, seed 11, unprotected and selective, 4,096
     under DWC and TMR (unfused: float regions; K1 launches a trip; 256
     rows against the CPU); unprotected
     with train_self_heal and train_sdc rows and no raw sdc, selective
     with corrected rows and fewer train_sdc;
 25. the sharded backend on the stencil (run before phase 18): fault-free
     rows clean under TMR and DWC in both voter placements, unfused and
     fused; ``run_distributed`` over a one-device mesh and a two-shard
     mesh on cuda:0 equal to ``golden_trajectory``; the reference's
     recorded study (``artifacts/stencil_campaign.json``, read as data:
     TMR, 128 rows, seed 7, both placements x single, cluster, link) with
     equal counts, blast radii, two-shard ledgers and containment block;
     8,192 injections at batch 4096, both placements, single and link
     faults, on the single-device runner (unfused and fused, K1/K2
     launches a trip from a CPU twin), a one-device mesh and the
     two-shard mesh, dense and sparse, and ``run_histogram``: equal codes
     and counts everywhere, 256 rows against the CPU; the supervisor CLI
     with ``--mesh 1 -f stencil --placement link --fault-model link -s
     interconnect`` against the runner (``--mesh 2`` exits 1 on a one-card
     machine); a one-rank nccl worker (``python -m
     coast_tpu_torch.parallel.multihost``) against ``run_histogram``;
 26. the log parser and the replication-integrity linter (run before
     phase 18): phase 9's 10^6-row dense campaign as a fresh ndjson log,
     summarised by the native classifier (``csrc/ndjson.cpp``), counts
     equal; a 16,384-row crc16 TMR campaign, dense and sparse, in
     json/ndjson/columnar, plain and ``.gz``, through the Python path,
     counts equal; ``lint_program`` with survival on the card (its trips
     and lane probes through K1 and K2) for matrixMultiply TMR/DWC, crc16
     fused, matrixMultiply1024 TMR, rtos_mm TMR and train_mlp TMR:
     findings equal the CPU's and the recorded sweep's
     (``artifacts/lint_sweep.json``); ``preflight="static"`` refuses a
     lane-averaging mutant built on the card; a crc16 TMR campaign at
     ``unroll=2`` equals one at ``unroll=1``, record for record;
 27. equivalence-reduced and delta campaigns (run before phase 18; the
     partition is derived on the host from the captured step, the
     campaigns run on the card): the reference's recorded parity study
     (``artifacts/equiv_study.json``, read as data: matrixMultiply and
     crc16, TMR and DWC, 16,384 at seed 2026) exhaustive and reduced,
     counts, physical rows and section modes equal to the record;
     matrixMultiply1024 TMR and DWC, 512 rows at 128, every class one
     outcome but those a zero float word splits at the compare's flush to
     zero (counted and shown); crc16 TMR fused reduced = unfused reduced
     (K2 launched), matrixMultiply TMR reduced sparse = reduced dense with
     the log's weights; delta campaigns from a 4096-row journal (a
     rebuilt crc16 re-injects no row, a matrixMultiply whose check xors
     golden with 0 re-injects golden's rows only), card fingerprints =
     host fingerprints; the CLI's ``--equiv`` on the card = on the host,
     ``--delta-from`` re-injecting no row, ``--static-budget`` without
     ``--stop-when`` refused; a two-shard mesh on cuda:0 with equiv = the
     single device;
 28. the static vulnerability map, the lane-isolation prover, the static
     budget and the advisor (run before phase 18; the analyses capture on
     the host, every campaign runs on the card): the maps of
     matrixMultiply TMR/DWC, crc16 TMR and matrixMultiply1024 TMR/DWC
     equal the recorded sweep's (``artifacts/lint_sweep.json``); live
     soundness (no SDC outside sdc-possible sections) on matrixMultiply
     TMR (1500 rows) and matrixMultiply1024 TMR/DWC (512 rows at 128);
     clean isolation proofs with the recorded voted commits, the seeded
     voter bypass refuted (crc16 unfused and fused, matrixMultiply1024)
     and launching no kernel, a fresh matrixMultiply1024 TMR campaign
     equal to phase 4's after it; static-budget delta campaigns (crc16
     TMR fused, matrixMultiply TMR, no-op and one-section edits) spending
     no more rows than plain ones; the advisor on the card = on the host
     (matrixMultiply), on matrixMultiply1024 at 512 rows with validation,
     with the static seed; the stencil's cross-shard reach and live
     soundness for both placements; ``opt -propOut``, the lint's
     ``--propagation``, the supervisor's ``--static-budget`` and the
     advisor's CLI as processes, each equal to the in-process result;
 29. the region lifters, the fuzz tier, the flag-matrix harness and the
     smoke drivers (run before phase 18): ``lift_step`` re-derives
     matrixMultiply1024 from its program (annotations ``first`` and
     ``second``) with the hand spec's kinds and 16 nominal steps, and its
     TMR and DWC campaigns (512 rows at 128, seed 1) equal the hand
     region's, through K1; lifted again with the lifter's own check
     (its golden made on the card), 128 fault-free rows read 0 errors and
     its TMR campaign classifies as the hand region's off the ``golden``
     leaf and ``mm256.order_sensitive``; the lifted crc16 under ``fuse_step=True``
     (4096 rows) equals the fused hand region's, through K2; ``lift_fn``
     of a scan over a 1 MiB carry (64 iterations) and of a while-then-scan
     function gives the function's eager result on the card, and a
     4096-row TMR campaign of each equals a CPU rerun on its first 64
     rows; ``fuzz -n 20 -d cuda`` prints Success!; the harness runs
     fast.yml's 4 x 3 matrix, full.yml's 18 OPT_PASSES on matrixMultiply
     and crc16 (every cell exits 0 with ``E: 0``) and the eight ported
     drivers (each prints Success!) on the card;
 30. observability (run before phase 18): (a) a profiled
     matrixMultiply1024 TMR campaign (512 rows at 128) with telemetry, a
     metrics hub served on a loopback port, its status file and a trace
     file: the attribution identity wall = device busy + host gap + host
     other, counts and codes equal to the same campaign with the profiler
     off, ``/metrics`` and ``/status`` (and the status file) at the
     finished rows, device-track spans in the trace, an ``mfu`` block
     naming the card, and ``device_busy_s`` at least the summed kernel
     time of the same campaign under ``torch.profiler`` (both printed);
     (b) the flight recorder's bundles of phase 16's wedged supervisor
     (its events and its torch/card metadata), checked in phase 16;
     (c) ``fused_smoke`` and ``obs_live_smoke`` on the card; (d) the cost
     of default telemetry on matrixMultiply TMR at 4096 rows a batch
     against ``obs.NULL`` (both rates printed, no claim);
 31. reliability SLOs and the verb dispatcher: (a) the flagship,
     matrixMultiply1024 TMR (512 rows at 128, profiled) with an attached
     SLO set, its verdicts in ``CampaignResult.slo``,
     ``summary()["slo"]``, the hub's ``/status`` and ``/metrics`` and the
     heartbeat and console line, ``p99_dispatch`` printed and not
     compared (the port's dispatch histogram is its busy window); (b)
     ``python -m coast_tpu_torch slo check`` on the recorded summary, exit
     0 on an attained spec and 1 on a seeded burn; (c) the supervisor's
     ``--slo`` as one process (fused, so K2 runs too), started at the
     phase's start; (d) ``slo_smoke -d cuda``;
 32. the campaign fleet and trace federation: (a) two matrixMultiply TMR
     items (16,384 rows at 4096, seeds 0 and 1) drained by ``python -m
     coast_tpu_torch.fleet run --workers 2`` on cuda:0, one worker
     SIGKILL'd mid-item and its replacement resuming the journal, the
     merged per-item ``codes_sha256`` and counts equal to the same two
     campaigns run in this process, at least one compile-cache hit, the
     fleet ``/metrics`` serving rates while the workers run, and the
     federated trace; (b) ``profile_smoke -d cuda`` and ``fleet_smoke -d
     cuda`` (a process of its own beside the fleet);
 33. the protection-regression CI: (a) ``python -m coast_tpu_torch ci
     check --workers 2 --device cuda`` of the committed
     ``artifacts/ci_baseline.json`` as one process (its two fleet workers
     on cuda:0), started at the phase's start: exit 0, every row of the
     four targets re-injected (13, 13, 535, 546; the baseline's section
     fingerprints are the reference's) and each target's counts equal to
     the baseline's; (b) ``ci_smoke -d cuda`` meanwhile (a two-target
     baseline, a no-op check re-injecting nothing, the weakened TMR build
     drifting while the DWC target stays consistent);
 34. continuous-protection serving: (a) ``ServeEngine`` on
     matrixMultiply1024, batch 32, half the rows injection lanes, TMR and
     DWC: both isolation proofs hold (the prover's seconds printed), a
     10-request stream and a 32-request burst all served ``success`` with
     the digest of a fault-free ``run_batch``, no lane leak, each lane's
     codes equal to ``run_batch`` of the same schedule rows, the 10-request
     stream byte-identical with injection lanes off; requests/s, p99
     request latency and injection inj/s printed; (b) ``python -m
     coast_tpu_torch serve matrixMultiply --device cuda`` as a process,
     started at the phase's start: 8 ``POST /v1/infer``, ``/status`` and
     ``/metrics``, SIGKILL'd once its DWC journal holds a batch, restarted
     on the same journals (run meanwhile with (a)), its injection codes
     equal to an uninterrupted in-process run; (c) ``serve_smoke -d
     cuda``;
 35. the restricted-C front end (``frontend.lift_c``): (a) the pycparser
     and gcc versions; (b) ``tests/c_sources/{mm9,crc16,gcd}.c`` lifted
     on the card: gcc's printed words (``-O1 -fwrapv -funsigned-char``)
     equal the lifted fault-free run's last output words and the oracle
     (models/mm.py's XOR and 0 errors, models/crc16.py's CRC, the gcds of
     gcd.c's arrays); TMR and DWC, 4096 injections at 4096, seed 1,
     unfused and ``-fuseStep``: fused = unfused on every row, K1 and K2
     launched exactly their per-trip counts times the trips, the first
     512 rows rerun on the CPU equal on every column; inj/s, trips and
     torch operators a trip; (c) ``python -m coast_tpu_torch.opt -TMR
     -countErrors mm9.c`` and a supervisor campaign on crc16.c whose
     reference-format log names the source on line 1, processes started
     at the phase's start; (d) ``python -m
     coast_tpu_torch.scripts.c_fuzz_sweep -n 20 -d cuda -j 4`` (gcc
     against the lifted run on the card, ``c_fuzz -n 20 -j 4``'s seeds,
     its record under ``build/``), started at the phase's start and read
     in phase 36: seeds 0-19 recorded as passing, no failure; its seeds'
     gcc, lift and run seconds are logged;
 36. the reliability studies of ``coast_tpu_torch/scripts``, each
     study's ``main`` called in this process one after another, while
     phase 35's sweep ends: (a)
     matrixMultiply and crc16 under unprotected, DWC and TMR at 20,000
     injections (one batch, seed 2026) on the card, their first 512 rows
     rerun on the CPU (in worker processes) and their counts equal to
     ``artifacts/mwtf_report.json``'s (read as data); ``mwtf_report`` on
     matrixMultiply and crc16 at 20,000, unfused and with
     ``--fuse-step``, whose counts equal those, then on
     matrixMultiply1024 at 512 (batch 128); each row's MWTF, SDC and DUE
     ratios and seconds a fault-free run printed (quicksort's report,
     whose 20 timed fault-free runs of 2,320 trips a program take about
     260 s, is left out); (b) ``mwtf_report
     --model-sweep`` on matrixMultiply at 4096 (one batch): every series
     monotone; (c) ``fidelity_study`` at budget 14,000, seed 7: C1-C4
     pass, its section tables printed beside
     ``artifacts/fidelity_study.json``'s; (d) ``classification_parity``
     at 4096: matrixMultiply and crc16 bit-identical on the card and the
     CPU, every differing matrixMultiply256 row named and inside the f32
     exemption of phase 5; (e) ``train_campaign`` at 1,024 injections a
     strategy (the reference's default 2,048 halved): its three bars
     pass; (f) phase 35's sweep read, then run again on its record,
     skipping every seed; ``zero_to_aha.sh -d cuda`` on
     ``tests/c_sources/mm9.c`` with 512 injections (a chain of
     processes, one host thread each, started after phase 15 so that its
     lifts overlap phases 16-20) ends in exit 0;
 18. the device-only times of phases 3 and 7a (torch.profiler, 200 calls
     each), taken last: a profiler session leaves launch overhead behind
     that would slow the campaigns run after it.

Phases 19-24 and 36 rerun their CPU rows in three worker processes,
beside the card campaigns that follow; phases 20, 22, 23, 25 and 27
start their supervisor processes at the phase's start, phase 17 its two
after its runner campaigns: a process's start-up is host work that
overlaps the card's.

It prints the kernel table as one JSON line before the last (``ms``,
``plain_ms`` and ``bound_ms`` at the flagship shape, as before; every
timed shape, grouped ones included, under ``shapes``) and
``{"ok": true, "device": {...}}`` as the last line.  The kernels'
``launches`` count every campaign that ran them: K1 those of phases 4,
9-12, 14-17 and 19-36, K2 those of phases 7b, 9-12, 14-17, 19-23,
25-31, 35 and 36 (each
phase's counts set to 0 just before it and read just after; a supervisor
process, a fleet or ci worker, a serve process and a study process
report their own at exit, a SIGKILL'd one and the workflow's processes
nothing).  It imports nothing of JAX or of the coast_tpu package.
``launches_phase_28`` to ``launches_phase_36`` are those phases'
shares.

No process outlives the script: it is the child subreaper of all it
starts, names on stderr after each phase any process left there that it
did not start itself, and kills and reaps every one at its exit, on a
failure, on SIGTERM and at its own limit of 1,190 s.
"""

from __future__ import annotations

import ast
import atexit
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# The package sits beside this script: make it importable from any working
# directory (``python3 /path/to/chip_smoke.py``).
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet


# Every process the script starts.  The script is the child subreaper of
# all that runs under it (become_subreaper), so a process whose parent
# ends first -- multiprocessing's resource tracker behind c_fuzz's worker
# pool, what a killed supervisor or fleet worker left -- is handed to the
# script rather than to init.  fail() and the script's exit kill and reap
# every child still there, so none outlives the script.
CHILDREN: list = []
PR_SET_CHILD_SUBREAPER = 36
# The script's own time limit, a little short of the 1,200 s it is given.
DEADLINE_S = 1190


def spawn(argv, **kw) -> subprocess.Popen:
    """``subprocess.Popen`` in a session of its own, recorded in
    :data:`CHILDREN`."""
    proc = subprocess.Popen(argv, start_new_session=True, **kw)
    CHILDREN.append(proc)
    return proc


def become_subreaper() -> None:
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        fail("prctl(PR_SET_CHILD_SUBREAPER) failed: "
             f"{os.strerror(ctypes.get_errno())}")


def own_children() -> dict:
    """pid -> (state, command line) of every process, running or not yet
    reaped, whose parent is this script."""
    me = str(os.getpid())
    found = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                comm, rest = fh.read().split("(", 1)[1].rsplit(")", 1)
            fields = rest.split()
            if fields[1] != me:
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                cmd = fh.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        # A zombie has no command line left: its name stands in.
        found[int(entry)] = (fields[0], cmd.strip()[:300] or f"[{comm}]")
    return found


def name_strays(where: str) -> None:
    """Name on stderr each child of the script that it did not start
    through :func:`spawn` and that is still there after ``where``: an
    orphan handed to it, or a process a phase did not wait for."""
    known = {proc.pid for proc in CHILDREN}
    if "pool" in RERUNS:
        # The CPU-rerun pool's workers and multiprocessing's resource
        # tracker, which the pool started.
        from multiprocessing import resource_tracker
        known |= set(getattr(RERUNS["pool"], "_processes", None) or ())
        known.add(getattr(resource_tracker._resource_tracker, "_pid", None))
    for pid, (state, cmd) in sorted(own_children().items()):
        if pid not in known:
            print(f"chip_smoke: after {where}: process {pid} (state "
                  f"{state}) is left: {cmd}", file=sys.stderr, flush=True)


def stop_children() -> None:
    # Kill each running child's session, then kill and reap every child
    # of the script (those, what was handed to it or never waited for),
    # and then what they leave in turn.  Reaped with waitpid, not
    # Popen.wait, which a signal handler cannot call while the main
    # thread is inside it.
    for proc in CHILDREN:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for _ in range(100):
        left = own_children()
        if not left:
            return
        for pid, (state, cmd) in sorted(left.items()):
            print(f"chip_smoke: stopping process {pid} (state {state}): "
                  f"{cmd}", file=sys.stderr, flush=True)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            try:
                os.waitpid(pid, 0)
            except ChildProcessError:
                pass


atexit.register(stop_children)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    stop_children()
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one ``fn()`` call (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replica_set(rng, rows: int, n: int, width: int, dtype: str):
    """Seeded ``[rows, n, width]`` words: every lane a copy of one image,
    then single-lane flips in every odd row, and for float32 the specials
    (+0 beside -0 must agree, NaN never agrees) in every fourth row."""
    if dtype == "float32":
        base = rng.standard_normal((rows, width)).astype(np.float32)
    else:
        base = rng.integers(-2**31, 2**31, (rows, width), dtype=np.int64
                            ).astype(np.int32)
    lanes = np.repeat(base[:, None, :], n, axis=1)
    bits = lanes.view(np.int32)
    for r in range(1, rows, 2):
        bits[r, rng.integers(n), rng.integers(width)] ^= np.int32(
            1 << int(rng.integers(31)))
    if dtype == "float32":
        for r in range(0, rows, 4):
            w = rng.integers(width)
            lanes[r, :, w] = 0.0
            lanes[r, 1, w] = -0.0
            if r % 8 == 0 and width > 1:
                lanes[r, :, (w + 1) % width] = np.nan
    return lanes


def compare(torch, kernel, plain, what: str, name: str = "K1") -> float:
    """Fail unless the kernel's outputs (words..., flags) are bit-equal to
    the plain version's; return the max |difference| of the words."""
    torch.cuda.synchronize()
    worst = 0.0
    *kwords, km = kernel
    *pwords, pm = plain
    if not torch.equal(km, pm):
        fail(f"{name} flags differ from its plain version: {what}")
    for kv, pv in zip(kwords, pwords):
        if kv.shape != pv.shape or not torch.equal(kv.view(torch.int32),
                                                   pv.view(torch.int32)):
            fail(f"{name} differs from its plain version: {what}")
        diff = (kv.double() - pv.double()).abs()
        diff = diff[~diff.isnan()]
        if diff.numel():
            worst = max(worst, float(diff.max()))
    return worst


def compare_group(torch, got, want, what: str, name: str) -> float:
    """Fail unless a grouped call's outputs (lists of tensors or None per
    site, then the [S, R] flag block) are bit-equal to the plain
    version's; return the max |difference| of the words."""
    torch.cuda.synchronize()
    *got_lists, got_flags = got
    *want_lists, want_flags = want
    if not torch.equal(got_flags, want_flags):
        fail(f"{name} flags differ from its plain version: {what}")
    words_got = [t for lst in got_lists for t in lst]
    words_want = [t for lst in want_lists for t in lst]
    if [t is None for t in words_got] != [t is None for t in words_want]:
        fail(f"{name} returns other outputs than its plain version: {what}")
    pairs = [(g, w) for g, w in zip(words_got, words_want) if g is not None]
    return max([compare(torch, (g, want_flags), (w, want_flags), what, name)
                for g, w in pairs] or [0.0])


def device_ms(torch, fn, calls: int = 200):
    """Device time of one ``fn()`` call: the summed self time of every
    device activity (kernels and memsets) over ``calls`` calls under
    torch.profiler, over ``calls``.  None when the profiler saw none."""
    from coast_tpu_torch.breakdown import kernel_times
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(k["us"] for k in kernel_times(prof))
    return us / calls / 1e3 if us > 0 else None


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def defer_device_ms(later: list, name: str, record: dict, key: str,
                    fn) -> None:
    """Queue the device-only time of ``fn`` for ``record[key]``.  Phase 18
    runs the queue after every campaign: a torch.profiler session leaves
    launch overhead behind that slows the campaigns run after it."""
    record[key] = None
    later.append((name, record, key, fn))


def time_group(torch, later: list, name: str, label: str, grouped, leaves,
               plain, bound_bytes: int, card: str, iters: int = 50) -> dict:
    """One grouped launch (``grouped``) timed per call (CUDA events around
    one call, host work included), beside the same sites as groups of one
    (``leaves``: one launch a leaf, the per-leaf form), the plain version
    and the bytes bound of the group; the device-only times of the first
    two (torch.profiler over 200 calls) are queued for phase 18."""
    res = {"shape": label,
           "ms": time_ms(torch, grouped, iters),
           "per_leaf_ms": time_ms(torch, leaves, iters),
           "plain_ms": time_ms(torch, plain, max(5, iters // 5)),
           "bound_ms": bound_bytes / H100_BYTES_PER_S * 1e3}
    defer_device_ms(later, name, res, "device_ms", grouped)
    defer_device_ms(later, name, res, "per_leaf_device_ms", leaves)
    log(f"{name} {label}: one launch {res['ms']:.4f} ms per call; groups "
        f"of one {res['per_leaf_ms']:.4f} ms per call; plain "
        f"{res['plain_ms']:.4f} ms; bound {res['bound_ms']:.4f} ms by "
        f"bytes [{card}]")
    return res


def k1_bytes(sites, n: int) -> int:
    """Bytes a grouped vote must move: every lane word read once, each
    written voted word (TMR, or a DWC copy) and each flag written once."""
    total = 0
    for site in sites:
        rows = site.lanes.shape[0]
        width = site.width or site.lanes.numel() // (rows * n)
        total += rows * n * width * 4 + rows * 4
        if n == 3 or site.copy:
            total += rows * width * 4
    return total


def k2_bytes(sites, n: int) -> int:
    """Bytes a grouped fused commit must move: lanes (and masks) read
    once, the repaired lanes, the voted words and the flags written once."""
    total = 0
    for lanes, masks in sites:
        rows, words = lanes.shape[0], lanes.numel()
        total += (2 + (masks is not None)) * words * 4 + words // n * 4
        total += rows * 4
    return total


def mark_rows(torch, pstate, names, n: int) -> None:
    """Flip one word of one lane in every odd row of every named leaf, so
    the timed groups carry miscompares (odd rows) beside agreement."""
    for k, name in enumerate(names):
        words = pstate[name].view(torch.int32).view(
            pstate[name].shape[0], n, -1)
        words[1::2, (k + 1) % n, 0] ^= 1 << 5


def check_k1(torch, hv, voters) -> float:
    """Phase 3a: kernel vs plain, bit-equal.  Returns max |difference|."""
    rng = np.random.default_rng(1234)
    worst = 0.0
    cases = 0
    for width, rows in ((1, 64), (81, 64), (131072, 8), (1048576 + 3, 4)):
        for n in (2, 3):
            for dtype in ("int32", "float32"):
                host = replica_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                worst = max(worst, compare(
                    torch, hv.vote(lanes, n), voters.vote(lanes, n),
                    f"width {width} n {n} {dtype}"))
                # The per-row window form: read in place at row offsets.
                width_w = max(1, width // 3)
                offs = torch.from_numpy(rng.integers(
                    0, width - width_w + 1, rows).astype(np.int32)).cuda()
                worst = max(worst, compare(
                    torch, hv.vote_window(lanes, offs, width_w, n),
                    voters.vote(voters.window(lanes, offs, width_w), n),
                    f"window {width_w} of {width} n {n} {dtype}"))
                cases += 2
    log(f"K1 bit-equal to its plain version on {cases} seeded cases "
        f"(n 2/3, int32/float32 with +-0 and NaN, widths 1..1048579, "
        f"window form)")
    return max(worst, check_k1_groups(torch, hv, voters))


def check_k1_groups(torch, hv, voters) -> float:
    """Phase 3a, grouped: one launch over sites of mixed width (1, 13, 81
    as 9x9, 131072 or 1048579 words) and dtype, per-row windows of the
    widest, written DWC copies beside flags-only checks; bit-equal to the
    plain ``voters.vote_sites``."""
    rng = np.random.default_rng(99)
    worst = 0.0
    cases = 0
    for rows, wide in ((64, 131072), (4, 1048576 + 3)):
        for n in (2, 3):
            sites = []
            for j, (width, dtype, shape) in enumerate((
                    (1, "int32", ()), (13, "float32", (13,)),
                    (81, "int32", (9, 9)), (wide, "float32", (wide,)),
                    (wide, "int32", (wide,)))):
                host = replica_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda().view(
                    (rows, n) + shape)
                sites.append(voters.Site(lanes, copy=bool(j % 2)))
            for j, width in enumerate((7, wide // 3)):
                offs = torch.from_numpy(rng.integers(
                    -9, wide, rows).astype(np.int32)).cuda()
                sites.append(voters.Site(sites[3 + j].lanes, offs, width,
                                         copy=bool(j)))
            worst = max(worst, compare_group(
                torch, hv.vote_sites(sites, n), voters.vote_sites(sites, n),
                f"group of {len(sites)} sites, rows {rows}, n {n}", "K1"))
            cases += 1
    log(f"K1 grouped launches bit-equal to the plain vote_sites on {cases} "
        "seeded groups (widths 1..1048579 in one launch, int32 and float32, "
        "windows, DWC copies and flags-only checks)")
    return worst


def time_k1_groups(torch, later, hv, voters, TMR, DWC, REGISTRY, card):
    """Phase 3c: K1 at the grouped shapes of the engine's sync points --
    the 9x9 unfused step's pre-step and commit groups (and the commit's
    81-word leaf alone) and its boundary group (TMR and DWC) at batch
    4096, the matrixMultiply1024 boundary
    group at batch 128 (TMR and DWC) -- each first held bit-equal to the
    plain version.  Returns the timing records."""
    Site = voters.Site
    out = []
    cases = [("matrixMultiply", 4096, TMR, "pre-step", ("i",)),
             ("matrixMultiply", 4096, TMR, "commit", ("results",)),
             ("matrixMultiply", 4096, TMR, "commit",
              ("results", "i", "phase")),
             ("matrixMultiply", 4096, TMR, "boundary", None),
             ("matrixMultiply", 4096, DWC, "boundary", None),
             ("matrixMultiply1024", 128, TMR, "boundary", None),
             ("matrixMultiply1024", 128, DWC, "boundary", None)]
    for bench, rows, strat, point, names in cases:
        prog = strat(REGISTRY[bench]())
        n = prog.cfg.num_clones
        pstate, _ = prog.init_pstate(rows)
        names = names or [k for k in pstate if prog.replicated[k]]
        mark_rows(torch, pstate, names, n)
        sites = [Site(pstate[k]) for k in names]
        shapes = ", ".join(str(list(pstate[k].shape)) for k in names)
        dtype = "f32" if pstate[names[0]].is_floating_point() else "int32"
        label = (f"{bench} {strat.__name__} {point} "
                 + (f"group {{{shapes}}} {dtype}" if len(names) > 1
                    else f"{shapes} {dtype}"))
        compare_group(torch, hv.vote_sites(sites, n),
                      voters.vote_sites(sites, n), label, "K1")
        big = rows < 4096
        out.append(time_group(
            torch, later, "K1", label,
            lambda sites=sites, n=n: hv.vote_sites(sites, n),
            lambda sites=sites, n=n: [hv.vote(site.lanes, n)
                                      for site in sites],
            lambda: voters.vote_sites(sites, n), k1_bytes(sites, n), card,
            iters=20 if big else 50))
        del prog, pstate, sites
        torch.cuda.empty_cache()
    return out


def main_shape_lanes(torch, rows: int, n: int, words: int,
                     offs) -> "torch.Tensor":
    """A seeded ``[rows, n, words]`` f32 replica set on the card, with
    every mark inside each row's store-slice window (start ``offs[r]``):
    a single-lane flip in every odd row, +0 beside -0 in every fourth row
    and a NaN in every eighth."""
    gen = torch.Generator(device="cuda").manual_seed(7 + n)
    lanes = torch.randn((rows, 1, words), generator=gen, device="cuda"
                        ).expand(rows, n, words).contiguous()
    r = torch.arange(rows, device="cuda")
    start = offs.long()
    odd = r[1::2]
    lanes[odd, odd % n, start[odd] + odd] += 1.0
    fourth = r[0::4]
    lanes[fourth, :, start[fourth] + 1] = 0.0
    lanes[fourth, 1, start[fourth] + 1] = -0.0
    eighth = r[0::8]
    lanes[eighth, :, start[eighth] + 2] = float("nan")
    return lanes


def bound_ms_dwc(rows: int, words: int) -> float:
    """The flags-only DWC vote's bound: two lanes read, a flag a row."""
    return (rows * 2 * words * 4 + rows * 4) / H100_BYTES_PER_S * 1e3


def time_k1(torch, later, hv, voters) -> dict:
    """Phase 3b: K1 at the main path's shapes (matrixMultiply1024, batch
    128), for TMR (n 3) and DWC (n 2): the boundary vote of a 1024x1024
    f32 leaf and the store-slice vote of a 128-row window of it, at the
    window starts the campaign gives (row r: (r % 8) * 131072).  Each is
    first held bit-equal to its plain version, then timed.  Returns the
    TMR boundary vote's numbers for the kernel table."""
    rows, words, width = 128, 1024 * 1024, 128 * 1024
    offs = (torch.arange(rows, device="cuda", dtype=torch.int32) % 8) * width
    res = {"max_abs_err": 0.0}
    for n in (3, 2):
        lanes = main_shape_lanes(torch, rows, n, words, offs)
        err = max(
            compare(torch, hv.vote(lanes, n), voters.vote(lanes, n),
                    f"boundary vote [{rows}, {n}, {words}] f32"),
            compare(torch, hv.vote_window(lanes, offs, width, n),
                    voters.vote(voters.window(lanes, offs, width), n),
                    f"store-slice vote [{rows}, {n}, window {width} of "
                    f"{words}] f32"))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        ms = time_ms(torch, lambda: hv.vote(lanes, n))
        plain_ms = time_ms(torch, lambda: voters.vote(lanes, n))
        # TMR writes its voted copy; the whole-leaf DWC vote is flags only.
        bound_ms = (rows * n * words * 4 + rows * words * 4 + rows * 4
                    ) / H100_BYTES_PER_S * 1e3
        if n == 2:
            bound_ms = bound_ms_dwc(rows, words)
        log(f"K1 boundary vote [{rows}, {n}, {words}] f32: bit-equal, "
            f"{ms:.4f} ms (bound {bound_ms:.4f} ms by bytes, "
            f"{bound_ms / ms:.1%} of it); plain version {plain_ms:.4f} ms")
        record = {"shape": f"boundary [{rows}, {n}, {words}] f32", "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": bound_ms}
        defer_device_ms(later, "K1", record, "device_ms",
                        lambda lanes=lanes, n=n: hv.vote(lanes, n))
        res.setdefault("shapes", []).append(record)
        if n == 3:
            res.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        win_ms = time_ms(torch, lambda: hv.vote_window(lanes, offs, width, n))
        win_plain = time_ms(torch, lambda: voters.vote(
            voters.window(lanes, offs, width), n))
        win_bound = (rows * n * width * 4 + rows * width * 4 + rows * 4
                     ) / H100_BYTES_PER_S * 1e3
        log(f"K1 store-slice vote [{rows}, {n}, window {width} of {words}] "
            f"f32: bit-equal, {win_ms:.4f} ms (bound {win_bound:.4f} ms by "
            f"bytes); plain version (gather + vote) {win_plain:.4f} ms")
        record = {"shape": f"store-slice window [{rows}, {n}, {width} of "
                           f"{words}] f32", "ms": win_ms,
                  "plain_ms": win_plain, "bound_ms": win_bound}
        defer_device_ms(later, "K1", record, "device_ms",
                        lambda lanes=lanes, n=n: hv.vote_window(
                            lanes, offs, width, n))
        res["shapes"].append(record)
        del lanes
        torch.cuda.empty_cache()
    return res


def commit_set(rng, rows: int, n: int, width: int, dtype: str):
    """Seeded ``[rows, n, width]`` words and int32 flip masks for K2: the
    replica set of :func:`replica_set`, three mask flips in every row, and
    for float32 a subnormal beside zeros in one lane and a mask flip that
    turns a zero into a subnormal (both agree under the reference's
    compare)."""
    lanes = replica_set(rng, rows, n, width, dtype)
    bits = lanes.view(np.uint32)
    masks = np.zeros(lanes.shape, np.uint32)
    row = np.repeat(np.arange(rows), 3)
    np.bitwise_xor.at(masks, (row, rng.integers(n, size=3 * rows),
                              rng.integers(width, size=3 * rows)),
                      np.left_shift(np.uint32(1), rng.integers(
                          32, size=3 * rows).astype(np.uint32)))
    if dtype == "float32":
        r = np.arange(rows)

        def subnormals():
            return np.left_shift(np.uint32(1), rng.integers(
                23, size=rows).astype(np.uint32))

        w = rng.integers(width, size=rows)
        bits[r, :, w] = 0
        bits[r, r % n, w] = subnormals()
        w = rng.integers(width, size=rows)
        bits[r, :, w] = 0
        masks[r, (r + 1) % n, w] ^= subnormals()
    return lanes, masks.view(np.int32)


def check_k2(torch, fs) -> float:
    """Phase 7a: K2 vs its plain version, bit-equal, with and without masks.
    Returns the max |difference| of the output words."""
    rng = np.random.default_rng(4321)
    worst = 0.0
    cases = 0
    sets = [(64, width) for width in (1, 13, 81)]
    sets += [(8, 131072), (4, 1048576 + 3)]
    # The fused path's shapes: mm's results and scalars, crc16's message.
    sets += [(4096, 81), (4096, 1), (4096, 13)]
    for rows, width in sets:
        for n in (2, 3):
            for dtype in ("int32", "float32"):
                host, host_masks = commit_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                masks = torch.from_numpy(host_masks).cuda()
                if width == 1:
                    lanes, masks = lanes[:, :, 0], masks[:, :, 0]
                for m in (None, masks):
                    worst = max(worst, compare(
                        torch, fs.vote_flip_commit(lanes, m, n),
                        fs.plain_vote_flip_commit(lanes, m, n),
                        f"[{rows}, {n}, {width}] {dtype} "
                        f"{'masked' if m is not None else 'no mask'}", "K2"))
                    cases += 1
    log(f"K2 bit-equal to its plain version on {cases} seeded cases (n 2/3, "
        "int32/float32 with +-0, NaN and subnormals, with and without "
        "masks, widths 1..1048579, the fused path's [4096, n, 81/1/13])")
    return max(worst, check_k2_groups(torch, fs))


def check_k2_groups(torch, fs) -> float:
    """Phase 7a, grouped: one launch over sites of mixed width (1, 13, 81,
    131072 or 1048579 words), dtype and mask; bit-equal to the plain
    ``plain_commit_sites``."""
    rng = np.random.default_rng(77)
    worst = 0.0
    cases = 0
    for rows, wide in ((64, 131072), (4, 1048576 + 3), (4096, 81)):
        for n in (2, 3):
            sites = []
            for j, (width, dtype) in enumerate((
                    (1, "int32"), (13, "float32"), (81, "int32"),
                    (wide, "float32"), (wide, "int32"))):
                host, host_masks = commit_set(rng, rows, n, width, dtype)
                lanes = torch.from_numpy(host).cuda()
                masks = torch.from_numpy(host_masks).cuda()
                if width == 1:
                    lanes, masks = lanes[:, :, 0], masks[:, :, 0]
                sites.append((lanes, masks if j % 2 else None))
            worst = max(worst, compare_group(
                torch, fs.commit_sites(sites, n),
                fs.plain_commit_sites(sites, n),
                f"group of {len(sites)} sites, rows {rows}, n {n}", "K2"))
            cases += 1
    log(f"K2 grouped launches bit-equal to the plain commit_sites on {cases} "
        "seeded groups (widths 1..1048579 in one launch, int32 and float32, "
        "with and without masks)")
    return worst


def time_k2_groups(torch, later, fs, TMR, REGISTRY, card):
    """Phase 7a, grouped timing: K2 at the fused 9x9 TMR step's pre-step
    and commit groups at batch 4096, each first held bit-equal to the
    plain version.  Returns the timing records."""
    prog = TMR(REGISTRY["matrixMultiply"](), fuse_step=True)
    pstate, _ = prog.init_pstate(4096)
    out = []
    for point, names in (("pre-step", ("i",)),
                         ("commit", ("results", "i", "phase"))):
        mark_rows(torch, pstate, names, 3)
        sites = [(pstate[k], None) for k in names]
        shapes = ", ".join(str(list(pstate[k].shape)) for k in names)
        label = (f"matrixMultiply TMR fused {point} "
                 + (f"group {{{shapes}}} int32" if len(names) > 1
                    else f"{shapes} int32"))
        compare_group(torch, fs.commit_sites(sites, 3),
                      fs.plain_commit_sites(sites, 3), label, "K2")
        out.append(time_group(
            torch, later, "K2", label,
            lambda sites=sites: fs.commit_sites(sites, 3),
            lambda sites=sites: [fs.vote_flip_commit(lanes, None, 3)
                                 for lanes, _ in sites],
            lambda: fs.plain_commit_sites(sites, 3), k2_bytes(sites, 3),
            card))
    return out


K2_SHAPES = ((128, 1048576, "float32"), (4096, 81, "int32"))


def time_k2(torch, later, fs, hv, repair, card: str) -> dict:
    """Phase 7a, timing: K2 (TMR, as the engine calls it, and masked) at
    [128, 3, 1048576] f32 and at the fused path's [4096, 3, 81] int32,
    beside its bytes bound, its plain version and K1 + the materialised
    repair it replaces.  Returns the flagship shape's numbers, with every
    shape's under "shapes"."""
    rng = np.random.default_rng(11)
    res, shapes = {}, []
    for rows, width, dtype in K2_SHAPES:
        if dtype == "float32":
            one = rng.standard_normal((rows, 1, width), dtype=np.float32)
        else:
            one = rng.integers(-2**31, 2**31, (rows, 1, width),
                               dtype=np.int32)
        lanes = torch.from_numpy(one).cuda().expand(rows, 3, width)
        lanes = lanes.contiguous()
        lanes.view(torch.int32)[1::2, 1, 7 % width] ^= 1 << 9
        masks = torch.zeros_like(lanes, dtype=torch.int32)
        masks[::3, 2, 3 % width] = 1 << 4
        what = f"[{rows}, 3, {width}] {dtype}"
        err = max(compare(torch, fs.vote_flip_commit(lanes, None, 3),
                          fs.plain_vote_flip_commit(lanes, None, 3), what,
                          "K2"),
                  compare(torch, fs.vote_flip_commit(lanes, masks, 3),
                          fs.plain_vote_flip_commit(lanes, masks, 3),
                          what + " masked", "K2"))
        iters = 20 if width > 81 else 200
        ms = time_ms(torch, lambda: fs.vote_flip_commit(lanes, None, 3),
                     iters)
        plain_ms = time_ms(
            torch, lambda: fs.plain_vote_flip_commit(lanes, None, 3), iters)
        k1_ms = time_ms(torch, lambda: repair(hv.vote(lanes, 3)[0],
                                              lanes.shape), iters)
        masked_ms = time_ms(torch, lambda: fs.vote_flip_commit(lanes, masks,
                                                               3), iters)
        words = rows * width
        # 3W read, 3W repaired + W voted written, a flag word a row; a
        # mask adds 3W read.
        bound_ms = (words * 4 * 7 + rows * 4) / H100_BYTES_PER_S * 1e3
        masked_bound = bound_ms + words * 4 * 3 / H100_BYTES_PER_S * 1e3
        log(f"K2 TMR {what}: bit-equal, {ms:.4f} ms (bound {bound_ms:.4f} "
            f"ms by bytes, {bound_ms / ms:.1%} of it); plain version "
            f"{plain_ms:.4f} ms; K1 + repair (what it replaces) "
            f"{k1_ms:.4f} ms; masked {masked_ms:.4f} ms (bound "
            f"{masked_bound:.4f} ms) [{card}]")
        record = {"shape": f"TMR {what}", "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": bound_ms, "k1_repair_ms": k1_ms}
        defer_device_ms(later, "K2", record, "device_ms",
                        lambda lanes=lanes: fs.vote_flip_commit(lanes, None,
                                                                3))
        shapes.append(record)
        if dtype == "float32":      # the flagship shape: the JSON's numbers
            res = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "k1_repair_ms": k1_ms, "shapes": shapes}
        res["max_abs_err"] = max(res.get("max_abs_err", 0.0), err)
        del lanes, masks, one
        torch.cuda.empty_cache()
    return res


# Grouped launches a loop trip, (K1, K2), per campaign and engine (fused or
# not): one per sync point that has sites.  mm TMR: pre-step, commit and
# the done() view's vote of ``i`` unfused; the pre-step and commit fused
# commits fused (done() reuses the commit's vote).  crc16 has no commit
# vote; its fused done() view still votes ``i`` on K1.  DWC: the pre-step
# and commit checks, flags only.  The boundary adds one K1 a batch.
PER_TRIP = {("matrixMultiply", "TMR"): {False: (3, 0), True: (0, 2)},
            ("matrixMultiply", "DWC"): {False: (2, 0), True: (2, 0)},
            ("crc16", "TMR"): {False: (2, 0), True: (1, 1)},
            ("crc16", "DWC"): {False: (1, 0), True: (1, 0)}}


def count_trips(prog) -> list:
    """Count the engine's loop trips (``step`` calls) on ``prog``."""
    trips = [0]
    step = prog.step

    def counting(*args):
        trips[0] += 1
        return step(*args)

    prog.step = counting
    return trips


def fused_path(torch, TMR, DWC, CampaignRunner, REGISTRY, hv, hc,
               card: str, pairs: int = 5) -> None:
    """Phase 7b: the fused engine on matrixMultiply and crc16.  After a
    warm-up of each engine, ``pairs`` pairs of campaigns, unfused and
    fused, alternating which runs first.  Fails unless every run's records
    equal the first run's and every run launched K1 and K2 exactly as
    ``PER_TRIP`` says, plus one K1 a batch at the boundary."""
    cols = ("codes", "errors", "corrected", "steps")
    for bench in ("matrixMultiply", "crc16"):
        region = REGISTRY[bench]()
        for strat in (TMR, DWC):
            name = f"{bench} {strat.__name__}"
            progs = {False: strat(region), True: strat(region,
                                                       fuse_step=True)}
            if progs[True]._fuse_plan is None:
                fail(f"{name}: fuse_step=True built no fused plan")
            runners = {f: CampaignRunner(p, strategy_name=strat.__name__)
                       for f, p in progs.items()}
            for f in (False, True):
                runners[f].run(4096, seed=0, batch_size=4096)
            trips = {f: count_trips(p) for f, p in progs.items()}
            rates = {False: [], True: []}
            launches = {False: [0, 0], True: [0, 0]}
            base = None
            for i in range(pairs):
                for f in ((False, True) if i % 2 == 0 else (True, False)):
                    k1, k2, t0 = hv.LAUNCHES, hc.LAUNCHES, trips[f][0]
                    res = runners[f].run(16384, seed=1, batch_size=4096)
                    got = (hv.LAUNCHES - k1, hc.LAUNCHES - k2)
                    per_k1, per_k2 = PER_TRIP[bench, strat.__name__][f]
                    n_trips = trips[f][0] - t0
                    want = (per_k1 * n_trips + 16384 // 4096,
                            per_k2 * n_trips)
                    if got != want:
                        fail(f"{name} fuse_step={f}: K1, K2 launches {got} "
                             f"over {n_trips} loop trips, not {want}")
                    launches[f][0] += got[0]
                    launches[f][1] += got[1]
                    rates[f].append(res.injections_per_sec)
                    if base is None:
                        base = res
                    elif res.counts != base.counts or not all(
                            np.array_equal(getattr(res, c), getattr(base, c))
                            for c in cols):
                        fail(f"{name}: fuse_step={f} records differ from "
                             "the unfused engine's")
            wins = sum(f > u for u, f in zip(rates[False], rates[True]))
            log(f"{name} {pairs} x 16384 inj at batch 4096 per engine: "
                f"{base.counts}; records equal fused vs unfused; "
                f"fused faster in {wins} of {pairs} pairs [{card}]")
            for f, label in ((False, "unfused"), (True, "fused")):
                log(f"  {label}: median "
                    f"{statistics.median(rates[f]):.1f} inj/s, runs "
                    f"{' / '.join(f'{r:.1f}' for r in rates[f])}; K1 "
                    f"{launches[f][0]}, K2 {launches[f][1]} launches over "
                    f"{trips[f][0]} loop trips "
                    f"({PER_TRIP[bench, strat.__name__][f]} a trip, one K1 "
                    "a batch at the boundary)")


GROUP_SPECS = ("multibit(k=4)", "cluster(span=4,k=3)",
               "burst(window=8,rate=0.5)")
GEN_SPECS = ("single",) + GROUP_SPECS
COLUMNS = ("codes", "errors", "corrected", "steps")


def records_differ(dense, other) -> str:
    """Why ``other`` (a dense or sparse result of the same schedule) does
    not match the dense result ``dense``; '' when its counts, interesting
    rows and their four columns (all rows, for a dense ``other``) agree."""
    if other.counts != dense.counts:
        return f"counts {other.counts} vs {dense.counts}"
    rows = np.flatnonzero(dense.codes > 1)      # class > CORRECTED
    if other.collect == "dense":
        rows = np.arange(dense.n)
    elif not np.array_equal(other.interesting_rows, rows):
        return (f"{len(other.interesting_rows)} interesting rows vs "
                f"{len(rows)}")
    for col in COLUMNS:
        got = getattr(other, col)
        if not np.array_equal(got, getattr(dense, col)[rows]):
            return f"column {col}"
    return ""


def rate_line(res) -> str:
    return (f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f} s), "
            f"transfer up {res.transfer['up']} B down "
            f"{res.transfer['down']} B")


def check_generator(torch, TMR, REGISTRY, MemoryMap, FaultModel, generate,
                    DeviceScheduleGen, card: str) -> None:
    """Phase 8: the device generator on the card against the host
    ``generate()``, bit-equal, for the four non-link kinds on the 9x9 and
    matrixMultiply1024 TMR maps, over 65,536 rows at a nonzero offset."""
    offset, rows = 131072 + 5, 65536
    for bench in ("matrixMultiply", "matrixMultiply1024"):
        prog = TMR(REGISTRY[bench]())
        mmap = MemoryMap(prog)
        steps = prog.region.nominal_steps
        idx = torch.arange(offset, offset + rows, device="cuda")
        for spec in GEN_SPECS:
            model = FaultModel.parse(spec)
            want = generate(mmap, offset + rows, 1, steps, model=model
                            ).slice(offset, offset + rows).device_arrays()
            got = DeviceScheduleGen(mmap, steps, model, "cuda").columns(
                1, offset + rows, idx)
            for key, col in want.items():
                if not np.array_equal(got[key].cpu().numpy(), col):
                    fail(f"device generator {spec} on {bench}: column "
                         f"{key} differs from the host generate()")
        log(f"device generator bit-equal to the host generate() on the "
            f"{bench} TMR map ({mmap.total_bits} bits): {', '.join(GEN_SPECS)}"
            f", rows {offset}..{offset + rows - 1} [{card}]")
        del prog, mmap
        torch.cuda.empty_cache()


def million(torch, TMR, REGISTRY, CampaignRunner, hv, hc, card: str) -> tuple:
    """Phase 9: matrixMultiply TMR, 10^6 injections at batch 65,536, seed
    1, dense and then sparse (each after a one-batch warm-up): counts,
    interesting rows and their columns equal.  Returns the (K1, K2)
    launches of the two campaigns and their results by collect mode."""
    prog = TMR(REGISTRY["matrixMultiply"]())
    runners = {c: CampaignRunner(prog, strategy_name="TMR", collect=c)
               for c in ("dense", "sparse")}
    for r in runners.values():
        r.run(65536, seed=0, batch_size=65536)
    res = {}
    hv.LAUNCHES = hc.LAUNCHES = 0
    for collect, r in runners.items():
        res[collect] = r.run(1_000_000, seed=1, batch_size=65536)
    launches = (hv.LAUNCHES, hc.LAUNCHES)
    if launches[0] <= 0:
        fail("the 10^6 campaigns launched K1 no time")
    why = records_differ(res["dense"], res["sparse"])
    if why:
        fail(f"10^6 matrixMultiply TMR: sparse differs from dense: {why}")
    for collect, r in res.items():
        n_int = int((r.codes > 1).sum())
        log(f"matrixMultiply TMR 10^6 at batch 65536 {collect}: {r.counts} "
            f"{rate_line(r)}, {n_int} interesting rows [{card}]")
    log(f"  sparse = dense (counts, interesting rows, columns); K1 "
        f"launches {launches[0]} over both")
    return launches, res


def flagship_sparse(torch, TMR, DWC, CampaignRunner, FaultModel,
                    REGISTRY, dense_results, hv, hc, card: str) -> tuple:
    """Phase 10: matrixMultiply1024 TMR and DWC, 1024 injections at batch
    128, sparse, against phase 4's dense results; the first interesting
    rows of the TMR campaign rerun densely from their base sites
    (``_rows_subset``); then multibit(k=2) under TMR, 512 injections
    dense and sparse.  Returns the (K1, K2) launches."""
    from coast_tpu_torch.inject.campaign import _rows_subset
    region = REGISTRY["matrixMultiply1024"]()
    hv.LAUNCHES = hc.LAUNCHES = 0
    for strat in (TMR, DWC):
        prog = strat(region)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        runner = CampaignRunner(prog, strategy_name=strat.__name__,
                                collect="sparse")
        res = runner.run(1024, seed=1, batch_size=128)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        why = records_differ(dense_results[strat], res)
        if why:
            fail(f"matrixMultiply1024 {strat.__name__} sparse differs from "
                 f"phase 4's dense run: {why}")
        log(f"matrixMultiply1024 {strat.__name__} sparse: {res.counts} "
            f"{rate_line(res)}, peak {peak:.2f} GiB; equal to phase 4's "
            f"dense run ({len(res.interesting_rows)} interesting rows) "
            f"[{card}]")
        if strat is TMR and len(res.interesting_rows):
            rows = res.interesting_rows[:4]
            again = CampaignRunner(prog).run_schedule(
                _rows_subset(res.schedule, rows), batch_size=len(rows))
            for col in COLUMNS:
                if not np.array_equal(getattr(again, col),
                                      getattr(res, col)[:len(rows)]):
                    fail("matrixMultiply1024 TMR: interesting rows rerun "
                         f"from their sites differ in {col}")
        del prog, runner
        torch.cuda.empty_cache()
    prog = TMR(region)
    model = FaultModel.multibit(k=2)
    out = {}
    for collect in ("dense", "sparse"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out[collect] = CampaignRunner(prog, strategy_name="TMR",
                                      fault_model=model, collect=collect
                                      ).run(512, seed=1, batch_size=128)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        log(f"matrixMultiply1024 TMR multibit(k=2) 512 at batch 128 "
            f"{collect}: {out[collect].counts} {rate_line(out[collect])}, "
            f"peak {peak:.2f} GiB [{card}]")
    why = records_differ(out["dense"], out["sparse"])
    if why:
        fail(f"matrixMultiply1024 TMR multibit(k=2): sparse differs: {why}")
    launches = (hv.LAUNCHES, hc.LAUNCHES)
    if launches[0] <= 0:
        fail("the flagship sparse campaigns launched K1 no time")
    log(f"  K1 launches {launches[0]} over the flagship sparse campaigns")
    return launches


def grouped(torch, TMR, DWC, CampaignRunner, FaultModel, REGISTRY, hv, hc,
            card: str) -> tuple:
    """Phase 11: flip groups through both engines -- matrixMultiply and
    crc16 under TMR and DWC with the three multi-site models, 16,384
    injections at batch 4096, seed 1, unfused and fused, dense and
    sparse: the four records equal.  Returns the (K1, K2) launches."""
    hv.LAUNCHES = hc.LAUNCHES = 0
    for bench in ("matrixMultiply", "crc16"):
        region = REGISTRY[bench]()
        for strat in (TMR, DWC):
            progs = {False: strat(region),
                     True: strat(region, fuse_step=True)}
            for spec in GROUP_SPECS:
                model = FaultModel.parse(spec)
                base, rates = None, []
                for fuse in (False, True):
                    for collect in ("dense", "sparse"):
                        res = CampaignRunner(
                            progs[fuse], strategy_name=strat.__name__,
                            fault_model=model, collect=collect).run(
                                16384, seed=1, batch_size=4096)
                        if base is None:
                            base = res
                        else:
                            why = records_differ(base, res)
                            if why:
                                fail(f"{bench} {strat.__name__} {spec} "
                                     f"fuse_step={fuse} {collect}: records "
                                     f"differ from unfused dense: {why}")
                        rates.append(f"{res.injections_per_sec:.1f}")
                log(f"{bench} {strat.__name__} {spec} 16384 at 4096: "
                    f"{base.counts}; four records equal; inj/s unfused "
                    f"dense/sparse, fused dense/sparse {' / '.join(rates)} "
                    f"[{card}]")
    launches = (hv.LAUNCHES, hc.LAUNCHES)
    if launches[0] <= 0 or launches[1] <= 0:
        fail(f"the grouped campaigns launched K1, K2 {launches} times")
    log(f"  K1 launches {launches[0]}, K2 {launches[1]} over the grouped "
        "campaigns")
    return launches


def overflow(TMR, CampaignRunner, REGISTRY, hv, hc, card: str) -> tuple:
    """Phase 12: one sparse campaign with ``sparse_capacity=1`` (every
    batch overflows and falls back to a dense fetch) equals dense."""
    prog = TMR(REGISTRY["matrixMultiply"]())
    hv.LAUNCHES = hc.LAUNCHES = 0
    dense = CampaignRunner(prog).run(16384, seed=1, batch_size=4096)
    tiny = CampaignRunner(prog, collect="sparse", sparse_capacity=1).run(
        16384, seed=1, batch_size=4096)
    launches = (hv.LAUNCHES, hc.LAUNCHES)
    why = records_differ(dense, tiny)
    if why:
        fail(f"sparse_capacity=1 differs from dense: {why}")
    log(f"matrixMultiply TMR 16384 at 4096, sparse_capacity=1: equal to "
        f"dense; {rate_line(tiny)} [{card}]")
    return launches


def sparse_batch_times(torch, TMR, REGISTRY, CampaignRunner, FaultModel,
                       generate, DeviceScheduleGen, fault_from_numpy,
                       card: str) -> list:
    """Phase 13: where a sparse batch's time goes, 65,536 rows of
    matrixMultiply TMR, CUDA events (host work included): the device
    generator's columns against the host ``generate()`` of a 65,536-row
    stream and the upload of its columns; the device accounting
    (``_sparse_device_outputs``) of one classified batch; the sparse
    fetch (histogram head, then bitmask and packed words) against the
    dense fetch of the four columns."""
    from coast_tpu_torch.inject import campaign as camp
    from coast_tpu_torch.inject import classify as cls
    prog = TMR(REGISTRY["matrixMultiply"]())
    mmap = CampaignRunner(prog).mmap
    steps = prog.region.nominal_steps
    rows = torch.arange(65536, device="cuda") + 131072
    records = []
    for spec in ("single", "burst(window=8,rate=0.5)"):
        model = FaultModel.parse(spec)
        gen = DeviceScheduleGen(mmap, steps, model)
        gen_ms = time_ms(torch, lambda: gen.columns(1, 1_000_000, rows))

        def host():
            cols = generate(mmap, 65536, 1, steps,
                            model=model).device_arrays()
            return fault_from_numpy(cols, "cuda")

        host_ms = time_ms(torch, host, iters=10)
        records.append({"what": f"{spec} columns, 65536 rows",
                        "device_gen_ms": gen_ms, "host_gen_upload_ms": host_ms})
        log(f"{spec} fault columns for 65536 rows: device generator "
            f"{gen_ms:.4f} ms; host generate() + upload {host_ms:.4f} ms "
            f"[{card}]")
    rec = prog.run_batch(DeviceScheduleGen(mmap, steps).columns(
        1, 1_000_000, rows))
    out = {k: rec[k].to(torch.int32) for k in ("errors", "corrected",
                                               "steps")}
    out["code"] = cls.classify(rec, prog.output_words)
    valid = torch.ones(65536, dtype=torch.bool, device="cuda")
    count_w = valid.to(torch.int32)
    cap = 65536 // 4                 # the runner's default at this batch
    pack = camp._pack_layout(prog.output_words, prog.region.max_steps)

    def account():
        return camp._sparse_device_outputs(out, count_w, valid, cap, pack)

    dev = account()
    k, ke = (int(x) for x in dev["head"][-2:].cpu())

    def sparse_fetch():
        dev["head"].cpu()
        return torch.cat([dev["mask"], dev["packed"][:k],
                          dev["exact"][:ke].flatten()]).cpu()

    def dense_fetch():
        return torch.stack([out[c] for c in ("code", "errors", "corrected",
                                             "steps")]).cpu()

    acct_ms = time_ms(torch, account, iters=50)
    sparse_ms = time_ms(torch, sparse_fetch, iters=50)
    dense_ms = time_ms(torch, dense_fetch, iters=50)
    records.append({"what": "accounting and fetch, 65536 rows",
                    "interesting": k, "device_accounting_ms": acct_ms,
                    "sparse_fetch_ms": sparse_ms, "dense_fetch_ms": dense_ms})
    log(f"one 65536-row batch ({k} interesting rows): device accounting "
        f"{acct_ms:.4f} ms; sparse fetch {sparse_ms:.4f} ms; dense fetch of "
        f"the four columns {dense_ms:.4f} ms [{card}]")
    return records


# -- phases 14-17: the supervisor CLI, its journal, retry and logs -----------

# Summary keys that differ between two runs of one campaign.
VOLATILE = ("seconds", "injections_per_sec", "stages", "transfer_bytes")
TIMESTAMP = re.compile(rb'"timestamp": "[^"]*"')

# Runs the supervisor module as ``python -m coast_tpu_torch.inject.supervisor``
# does, and at exit reports on stderr the process's K1 and K2 launches and
# its peak device memory (a process killed with SIGKILL reports nothing).
# With COAST_FLIGHTREC_DIR set it installs a flight recorder first, whose
# bundles land there.
SUPERVISOR = """\
import atexit, json, os, runpy, sys
from coast_tpu_torch.ops import hopper_commit, hopper_voters
if os.environ.get("COAST_FLIGHTREC_DIR"):
    from coast_tpu_torch.obs import flightrec
    flightrec.install(source="chip_smoke supervisor")


def report():
    import torch
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else 0)
    print("chip_smoke.report " + json.dumps(
        {"k1": hopper_voters.LAUNCHES, "k2": hopper_commit.LAUNCHES,
         "peak": peak}), file=sys.stderr, flush=True)


atexit.register(report)
runpy.run_module("coast_tpu_torch.inject.supervisor", run_name="__main__",
                 alter_sys=True)
"""


def start_cli(argv, board: str, env=None) -> subprocess.Popen:
    """Start one supervisor process on ``board`` from the checkout's root
    (``env``: more environment variables)."""
    return spawn(
        [sys.executable, "-c", SUPERVISOR, *argv, "-d", board], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_cli(proc: subprocess.Popen, what: str, expect_ok: bool = True,
               timeout: float = 600) -> dict:
    """Wait for a supervisor process: its exit code, output, printed
    summary (None if it printed none) and its exit report (K1/K2
    launches, peak device bytes).  Fails on a non-zero exit unless
    ``expect_ok`` is False."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{what}: the supervisor ran past {timeout} s")
    report = {"k1": 0, "k2": 0, "peak": 0}
    for line in err.splitlines():
        if line.startswith("chip_smoke.report "):
            report = json.loads(line.split(" ", 1)[1])
    if expect_ok and proc.returncode != 0:
        fail(f"{what}: the supervisor exited {proc.returncode}: "
             f"{err.strip()[-3000:]}")
    dicts = [ln for ln in out.splitlines() if ln.startswith("{")]
    summary = None
    if dicts:
        try:                       # a JSON line (the serve CLI's summary)
            summary = json.loads(dicts[-1])
        except ValueError:         # the supervisor's printed dict
            summary = ast.literal_eval(re.sub(r"(?<=: )inf\b", "1e999",
                                              dicts[-1]))
    return {**report, "rc": proc.returncode, "out": out, "err": err,
            "summary": summary}


def run_cli(argv, board: str, what: str, env=None, **kw) -> dict:
    return finish_cli(start_cli(argv, board, env), what, **kw)


def steady(summary: dict) -> dict:
    """A summary without the keys that differ between two runs."""
    return {k: v for k, v in summary.items() if k not in VOLATILE}


def journal_records(path) -> list:
    """A journal's complete records (a torn last line is left out)."""
    records = []
    with open(path, "rb") as f:
        for line in f:
            if not line.endswith(b"\n"):
                break
            records.append(json.loads(line))
    return records


def count_batches(path) -> int:
    try:
        return sum(r["kind"] == "batch" for r in journal_records(path))
    except FileNotFoundError:
        return 0                   # the process has not created it yet


def log_content(log_dir: Path, fmt: str) -> tuple:
    """The one log file in ``log_dir`` without its timestamps and its
    summary's volatile keys: (summary, per-injection bytes)."""
    names = os.listdir(log_dir)
    if len(names) != 1:
        fail(f"{log_dir}: expected one log file, found {names}")
    data = (log_dir / names[0]).read_bytes()
    if fmt == "ndjson":
        head, rows = data.split(b"\n", 1)
        return steady(json.loads(head)["summary"]), TIMESTAMP.sub(b"", rows)
    doc = json.loads(data)
    summary = steady(doc.pop("summary"))
    return summary, TIMESTAMP.sub(b"", json.dumps(doc).encode())


def check_same_run(what: str, got: dict, want: dict, got_dir: Path,
                   want_dir: Path, fmt: str) -> int:
    """Fail unless two supervisor runs of one campaign printed the same
    summary and wrote the same log, timestamps and volatile keys aside.
    Returns the log's per-injection bytes."""
    if steady(got["summary"]) != steady(want["summary"]):
        fail(f"{what}: summary {steady(got['summary'])} differs from the "
             f"uninterrupted run's {steady(want['summary'])}")
    got_log, want_log = log_content(got_dir, fmt), log_content(want_dir, fmt)
    if got_log[0] != want_log[0]:
        fail(f"{what}: the log's summary differs from the uninterrupted "
             "run's")
    if got_log[1] != want_log[1]:
        fail(f"{what}: the log's per-injection lines differ from the "
             "uninterrupted run's")
    return len(got_log[1])


# (label, argv, log format) of phase 14's two campaigns.
KILL_CAMPAIGNS = (
    ("matrixMultiply TMR dense, streamed ndjson",
     ["-f", "matrixMultiply", "-O", "-TMR", "--stream-logs", "--log-format",
      "ndjson"], "ndjson"),
    ("crc16 DWC fused sparse multibit(k=4), json",
     ["-f", "crc16", "-O", "-DWC -fuseStep", "--collect", "sparse",
      "--fault-model", "multibit(k=4)", "--log-format", "json"], "json"),
)


def kill_resume(work: Path, board: str, card: str, n: int = 262144,
                batch: int = 4096, kill_at: int = 8) -> tuple:
    """Phase 14: each campaign of ``KILL_CAMPAIGNS`` through the supervisor
    CLI, ``n`` injections at ``batch``, seed 5, with a journal: once
    uninterrupted; once killed with SIGKILL as soon as its journal holds
    ``kill_at`` batch records, then rerun with ``--resume``.  The resumed
    run's summary and log equal the uninterrupted run's, and its journal
    holds exactly ceil(n / batch) batch records.  The campaigns' processes
    overlap (every uninterrupted and to-be-killed run starts at once, the
    resumed runs as soon as the kills are done): each has its own journal
    and log directory, and a process's start-up is most of its wall.
    Returns the (K1, K2) launches and, for phase 16, the first campaign's
    argv, uninterrupted run and its log directory."""
    launches = [0, 0]
    first = None
    want_batches = -(-n // batch)
    runs = []
    for label, argv, fmt in KILL_CAMPAIGNS:
        argv = [*argv, "-t", str(n), "--batch-size", str(batch), "--seed",
                "5"]
        tag = argv[1]
        dirs = {k: work / f"{tag}_{k}" for k in ("full", "killed", "resumed")}
        for d in dirs.values():
            d.mkdir(parents=True)
        journal = work / f"{tag}_killed.ndjson"
        runs.append({
            "label": label, "argv": argv, "fmt": fmt, "dirs": dirs,
            "journal": journal, "t0": time.perf_counter(),
            "full": start_cli([*argv, "--journal",
                               str(work / f"{tag}_full.ndjson"), "-l",
                               str(dirs["full"])], board),
            "kill": start_cli([*argv, "--journal", str(journal), "-l",
                               str(dirs["killed"])], board)})
    t0 = time.perf_counter()
    waiting = list(runs)
    while waiting:
        for run in list(waiting):
            label, proc = run["label"], run["kill"]
            if count_batches(run["journal"]) >= kill_at:
                os.kill(proc.pid, signal.SIGKILL)
                killed = finish_cli(proc, f"{label}, killed",
                                    expect_ok=False)
                run["at_kill"] = at_kill = count_batches(run["journal"])
                if killed["rc"] != -signal.SIGKILL \
                        or at_kill >= want_batches:
                    fail(f"{label}: the kill did not cut the campaign (exit "
                         f"{killed['rc']}, {at_kill} of {want_batches} "
                         "batches)")
                run["resumed_t0"] = time.perf_counter()
                run["resume"] = start_cli([
                    *run["argv"], "--journal", str(run["journal"]),
                    "--resume", "-l", str(run["dirs"]["resumed"])], board)
                waiting.remove(run)
            elif proc.poll() is not None:
                finish_cli(proc, f"{label}, to be killed")
                fail(f"{label}: the campaign ended before its journal held "
                     f"{kill_at} batches")
        if time.perf_counter() - t0 > 600:
            fail(f"no {kill_at} batches journaled in 600 s")
        time.sleep(0.002)
    for run in runs:
        label, dirs, fmt = run["label"], run["dirs"], run["fmt"]
        full = finish_cli(run["full"], f"{label}, uninterrupted")
        full_s = time.perf_counter() - run["t0"]
        resumed = finish_cli(run["resume"], f"{label}, resumed")
        resumed_s = time.perf_counter() - run["resumed_t0"]
        size = check_same_run(f"{label}, resumed", resumed, full,
                              dirs["resumed"], dirs["full"], fmt)
        got_batches = count_batches(run["journal"])
        if got_batches != want_batches:
            fail(f"{label}: the resumed journal holds {got_batches} batch "
                 f"records, not {want_batches}")
        k1 = full["k1"] + resumed["k1"]
        k2 = full["k2"] + resumed["k2"]
        launches[0] += k1
        launches[1] += k2
        log(f"{label}, {n} at {batch} through the supervisor: SIGKILL after "
            f"{run['at_kill']} journaled batches, --resume gives the "
            f"uninterrupted counts {steady(full['summary'])} and "
            f"per-injection log ({size} bytes without timestamps); "
            f"{got_batches} batch records; uninterrupted {full_s:.2f} s, "
            f"resumed {resumed_s:.2f} s wall per process (the phase's "
            f"processes overlapped); K1 {k1}, K2 {k2} launches "
            f"(uninterrupted and resumed) [{card}]")
        if first is None:
            first = (run["argv"], full, dirs["full"], fmt)
    return tuple(launches), first


def oom_degrade(work: Path, board: str, card: str, torch, TMR, REGISTRY,
                CampaignRunner, order_sensitive, rows: int = 256,
                batch: int = 2048, bench: str = "matrixMultiply1024") -> tuple:
    """Phase 15: ``bench`` TMR through the supervisor, ``rows`` injections
    at a batch (``batch``) too large for the card, ``--max-retries 3``:
    the runner meets a real CUDA out-of-memory error, halves the batch
    until it fits and journals each geometry.  Its rows equal a batch-128
    run of the same rows outside ``mm256.order_sensitive``.  Returns the
    (K1, K2) launches."""
    journal = work / "oom.ndjson"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    run = run_cli(["-f", bench, "-O", "-TMR", "-t", str(rows), "--batch-size",
                   str(batch), "--max-retries", "3", "--journal",
                   str(journal), "-q"], board, f"{bench} at batch {batch}")
    wall = time.perf_counter() - t0
    records = journal_records(journal)
    sizes = [r["batch_size"] for r in records if r["kind"] == "geometry"]
    degrades = run["summary"].get("resilience", {}).get("oom_degrade", 0)
    if not sizes or degrades < 1:
        fail(f"{bench} at batch {batch}: no out-of-memory degradation "
             f"(geometry records {sizes}, oom_degrade {degrades})")
    batches = [r for r in records if r["kind"] == "batch"]
    got = {col: np.concatenate([np.asarray(r[col], np.int32)
                                for r in batches])
           for col in ("codes", "errors", "corrected", "steps")}
    from coast_tpu_torch.inject.supervisor import section_filter
    device = "cpu" if board == "cpu" else "cuda"
    prog = TMR(REGISTRY[bench](), device=device)
    want = CampaignRunner(prog, sections=section_filter(prog, "memory"),
                          strategy_name="TMR").run(rows, seed=0,
                                                   batch_size=128)
    sched = want.schedule
    exempt = order_sensitive(prog.leaf_order, sched.leaf_id, sched.bit)
    differ = np.zeros(rows, bool)
    for col in got:
        differ |= got[col] != getattr(want, col)
        if differ[~exempt].any():
            fail(f"{bench} degraded run: {col} differs from the batch-128 "
                 "run outside the f32 exemption")
    if steady(run["summary"])["injections"] != rows:
        fail(f"{bench} degraded run covers {run['summary']['injections']} "
             f"rows, not {rows}")
    log(f"{bench} TMR {rows} at batch {batch} through the supervisor: "
        f"out of memory, degraded {degrades} times (batch "
        f"{' -> '.join(map(str, [batch, *sizes]))}), settled at batch "
        f"{sizes[-1]}; process peak "
        f"{run['peak'] / 2**30:.2f} GiB (max_memory_allocated); rows equal "
        f"the batch-128 run ({int(exempt.sum())} exempt, {int(differ.sum())}"
        f" of them differ); {steady(run['summary'])}; {wall:.2f} s wall; "
        f"K1 {run['k1']}, K2 {run['k2']} launches [{card}]")
    del prog, want
    torch.cuda.empty_cache()
    return run["k1"], run["k2"]


def watchdog(work: Path, board: str, card: str, first) -> tuple:
    """Phase 16: phase 14's first campaign with ``--collect-timeout 1e-6
    --max-retries 1``: every collect outlives the watchdog, so the run
    exits non-zero with CampaignWedgedError and an intact journal; then
    ``--resume`` without the timeout completes, equal to phase 14's
    uninterrupted run.  The wedged process runs with a flight recorder
    (phase 30b): each watchdog fire and the crash dump a bundle, whose
    events and torch/card metadata are checked.  Returns the (K1, K2)
    launches."""
    argv, full, full_dir, fmt = first
    journal = work / "wedged.ndjson"
    wedged_dir, resumed_dir = work / "wedged", work / "wedged_resumed"
    bundles_dir = work / "flightrec"
    wedged_dir.mkdir()
    resumed_dir.mkdir()
    wedged = run_cli([*argv, "--journal", str(journal), "-l",
                      str(wedged_dir), "--collect-timeout", "1e-6",
                      "--max-retries", "1"], board, "wedged campaign",
                     env={"COAST_FLIGHTREC_DIR": str(bundles_dir)},
                     expect_ok=False)
    if wedged["rc"] == 0 or "CampaignWedgedError" not in wedged["err"]:
        fail(f"the wedged campaign exited {wedged['rc']} without "
             f"CampaignWedgedError: {wedged['err'][-2000:]}")
    records = journal_records(journal)
    kinds = [r["kind"] for r in records]
    retries = kinds.count("retry")
    if not kinds or kinds[0] != "header" or retries < 1:
        fail(f"the wedged campaign's journal holds {kinds}")
    if os.listdir(wedged_dir):
        fail("the wedged campaign left a log behind")
    check_bundles(bundles_dir, retries, card)
    resumed = run_cli([*argv, "--journal", str(journal), "--resume", "-l",
                       str(resumed_dir)], board, "wedged campaign, resumed")
    check_same_run("wedged campaign, resumed", resumed, full, resumed_dir,
                   full_dir, fmt)
    log(f"{argv[1]} with --collect-timeout 1e-6 --max-retries 1: exit "
        f"{wedged['rc']}, CampaignWedgedError, journal intact ({len(kinds)} "
        f"records: {kinds.count('batch')} batches, {retries} retry); "
        f"--resume without the timeout equals phase 14's uninterrupted run; "
        f"K1 {wedged['k1'] + resumed['k1']}, K2 "
        f"{wedged['k2'] + resumed['k2']} launches [{card}]")
    return (wedged["k1"] + resumed["k1"], wedged["k2"] + resumed["k2"])


def check_bundles(bundles_dir: Path, retries: int, card: str) -> None:
    """Phase 30b: the flight recorder's bundles of the wedged supervisor.
    Each watchdog fire dumps one (``watchdog_wedge``, with the process's
    thread stacks) and the crash one more; the crash bundle's events
    run from the journal's open through the dispatches, fires and retries
    to the crash, and its metadata names torch, its CUDA build, the card
    and its power limit as ``nvidia-smi`` gives them."""
    names = sorted(os.listdir(bundles_dir)) if bundles_dir.exists() else []
    docs = [json.loads((bundles_dir / n).read_text()) for n in names
            if n.startswith("flightrec_") and n.endswith(".json")]
    reasons = [d["reason"] for d in docs]
    fires = reasons.count("watchdog_wedge")
    crash = [d for d in docs
             if d["reason"] == "campaign_crash:CampaignWedgedError"]
    if fires != retries + 1 or len(crash) != 1 \
            or any(d["format"] != "coast-flightrec" for d in docs):
        fail(f"phase 30b: the wedged supervisor's bundles are {reasons} "
             f"({retries} retry)")
    if not all("[MainThread]" in d["stacks"] for d in docs):
        fail("phase 30b: a bundle lacks the process's thread stacks")
    events = [e["event"] for e in crash[0]["events"]]
    want = ["journal_open", "dispatch", "watchdog_fired", "retry",
            "campaign_crash"]
    if [e for e in want if e not in events] or events[-1] != \
            "campaign_crash" or events.count("watchdog_fired") != fires:
        fail(f"phase 30b: the crash bundle's events are {events}")
    meta = crash[0]["torch"]
    name, limit = card.rsplit(", ", 1)
    if (meta.get("backend") != "gpu" or meta.get("device_name") != name
            or meta.get("power_limit") != limit
            or not meta.get("cuda_version")
            or not meta.get("torch_version")):
        fail(f"phase 30b: the bundle's metadata is {meta}, the card "
             f"{card!r}")
    log(f"phase 30b: {len(docs)} flight-recorder bundles of the wedged "
        f"supervisor ({fires} watchdog_wedge, 1 campaign_crash); the crash "
        f"bundle's {len(events)} events {sorted(set(events))}; metadata "
        f"torch {meta['torch_version']} cuda {meta['cuda_version']} "
        f"{meta['device_name']}, {meta['power_limit']} [{card}]")


def durability(work: Path, board: str, card: str, TMR, REGISTRY,
               CampaignRunner, StreamLogWriter, bare: dict,
               n: int = 1_000_000, batch: int = 65536) -> tuple:
    """Phase 17: what durability costs the 10^6 campaign of phase 9
    (matrixMultiply TMR at ``batch``, seed 1), dense and sparse: through
    the runner with a journal and a streamed ndjson log, then through the
    supervisor CLI with ``--journal --stream-logs --log-format ndjson``
    (which draws from its default section, memory; the dense and the
    sparse process side by side).  The runner's counts
    equal phase 9's (``bare``), the CLI's dense counts its sparse counts;
    prints each rate beside phase 9's
    and the journal's and the log's bytes.  Returns the (K1, K2)
    launches of the runner's campaigns and the CLI's."""
    from coast_tpu_torch.ops import hopper_commit as hc
    from coast_tpu_torch.ops import hopper_voters as hv
    device = "cpu" if board == "cpu" else "cuda"
    prog = TMR(REGISTRY["matrixMultiply"](), device=device)
    launches = [0, 0]
    cli_counts = {}
    runs = {}
    for collect in ("dense", "sparse"):
        runner = CampaignRunner(prog, strategy_name="TMR", collect=collect)
        runner.run(batch, seed=0, batch_size=batch)     # warm-up, as phase 9
        journal = work / f"durable_{collect}.ndjson"
        path = work / f"durable_{collect}.json"
        hv.LAUNCHES = hc.LAUNCHES = 0
        t0 = time.perf_counter()
        stream = StreamLogWriter(str(path), runner.mmap, fmt="ndjson")
        res = runner.run(n, seed=1, batch_size=batch, journal=str(journal),
                         stream=stream)
        stream.finish(res)
        wall = time.perf_counter() - t0
        runner_launches = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += hv.LAUNCHES
        launches[1] += hc.LAUNCHES
        if res.counts != bare[collect].counts:
            fail(f"durable {collect} 10^6: counts {res.counts} differ from "
                 f"phase 9's {bare[collect].counts}")
        sizes = (journal.stat().st_size, path.stat().st_size)
        journal.unlink()
        path.unlink()
        runs[collect] = (res, wall, runner_launches, sizes)
    # The CLI's campaigns, dense and sparse side by side (a process's
    # start-up is most of its wall).
    procs = {}
    for collect in ("dense", "sparse"):
        cli_dir = work / f"durable_cli_{collect}"
        cli_dir.mkdir()
        cli_journal = work / f"durable_cli_{collect}.ndjson"
        procs[collect] = (time.perf_counter(), cli_dir, cli_journal, start_cli(
            ["-f", "matrixMultiply", "-O", "-TMR", "-t", str(n),
             "--batch-size", str(batch), "--seed", "1", "--collect", collect,
             "--journal", str(cli_journal), "--stream-logs", "--log-format",
             "ndjson", "-l", str(cli_dir)], board))
    # Meanwhile the native encoder against the Python formatter on this
    # machine's host: phase 9's dense 10^6 rows, one-shot, the same row
    # bytes.
    from coast_tpu_torch.inject import logs
    res, mmap = bare["dense"], CampaignRunner(prog).mmap
    ts = "2026-01-01 00:00:00.000000"
    paths = {"python": work / "rows_py.json", "native": work / "rows.json"}
    secs = {}
    t0 = time.perf_counter()
    logs._write_ndjson_py(res, mmap, ts, str(paths["python"]))
    secs["python"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    logs._write_ndjson_native(res, mmap, ts, str(paths["native"]))
    secs["native"] = time.perf_counter() - t0
    rows = {k: p.read_bytes().split(b"\n", 1)[1] for k, p in paths.items()}
    if rows["python"] != rows["native"]:
        fail("phase 17: the native encoder's rows differ from the Python "
             "formatter's")
    for p in paths.values():
        p.unlink()
    log(f"{res.n} dense rows to one ndjson log on the host: Python "
        f"formatter {secs['python']:.2f} s ({res.n / secs['python']:.1f} "
        f"rows/s), native encoder {secs['native']:.2f} s "
        f"({res.n / secs['native']:.1f} rows/s), "
        f"{secs['python'] / secs['native']:.1f}x; the same "
        f"{len(rows['native'])} row bytes [{card}]")
    for collect in ("dense", "sparse"):
        res, wall, runner_launches, sizes = runs[collect]
        t0, cli_dir, cli_journal, proc = procs[collect]
        cli = finish_cli(proc, f"durable {collect} 10^6 CLI")
        cli_wall = time.perf_counter() - t0
        launches[0] += cli["k1"]
        launches[1] += cli["k2"]
        # The CLI draws from its default section, memory: other counts
        # than phase 9's whole map, the same in both collect modes.
        counts = {k: cli["summary"][k] for k in bare[collect].counts}
        if cli_counts.setdefault("memory", counts) != counts:
            fail(f"durable 10^6 CLI: {collect} counts {counts} differ from "
                 f"dense {cli_counts['memory']}")
        cli_sizes = (cli_journal.stat().st_size,
                     sum(p.stat().st_size for p in cli_dir.iterdir()))
        cli_journal.unlink()
        shutil.rmtree(cli_dir)
        stages = {k: round(v, 4) for k, v in res.stages.items()}
        log(f"matrixMultiply TMR {n} at {batch} {collect}: phase 9 without "
            f"durability {bare[collect].injections_per_sec:.1f} inj/s; with "
            f"a journal and a streamed ndjson log, runner "
            f"{res.injections_per_sec:.1f} inj/s in run ({n / wall:.1f} "
            f"inj/s to the log's finish, {wall:.2f} s, against "
            f"{PYTHON_TO_FINISH[collect]} inj/s with the Python formatter "
            f"(PERF.md); stages {stages}, serialize = seconds not overlapped, "
            f"overlap = share of the serialization that overlapped "
            f"dispatch); supervisor CLI "
            f"{cli['summary']['injections_per_sec']:.1f} inj/s in run "
            f"({cli_wall:.2f} s process wall, dense and sparse side by "
            f"side, stages "
            f"{cli['summary']['stages']}); journal {sizes[0]} B, log "
            f"{sizes[1]} B (CLI {cli_sizes[0]} B, {cli_sizes[1]} B); K1 "
            f"{runner_launches[0]} (runner) + {cli['k1']} (CLI), K2 "
            f"{runner_launches[1]} + {cli['k2']} launches [{card}]")
    return tuple(launches)


# Phase 17's rates to the log's finish when the Python formatter wrote the
# dense rows (two runs on "NVIDIA H100 80GB HBM3, 700.00 W"; PERF.md §6).
PYTHON_TO_FINISH = {"dense": "58,424.6-98,010.4",
                    "sparse": "397,197.7-522,761.3"}


# Phase 19: the BASELINE regions (configs 2-4): aes, sha256, quicksort and
# the CHStone suite, with quicksort (config 3) under DWC as well.
BASELINE = ("aes", "sha256", "quicksort", "chstone_mips", "chstone_sha",
            "chstone_adpcm", "chstone_blowfish", "chstone_dfadd",
            "chstone_dfmul", "chstone_dfdiv", "chstone_dfsin", "chstone_gsm",
            "chstone_motion", "chstone_jpeg")


def sync_launches(prog, hv, fs) -> tuple:
    """What one loop trip and one batch's boundary launch on ``prog``
    ((K1 calls, K2 calls), K1 calls), and the torch operators one trip
    dispatches, counted on a CPU twin of it: one trip of the engine's
    step (after a first one) and one boundary vote, two rows."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountOps(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            CountOps.ops += 1
            return func(*args, **(kwargs or {}))

    counts = {"K1": 0, "K2": 0}
    real = (hv.vote_sites, fs.commit_sites)

    def k1(sites, n):
        counts["K1"] += 1
        return real[0](sites, n)

    def k2(sites, n):
        counts["K2"] += 1
        return real[1](sites, n)

    twin = type(prog)(prog.region, prog.cfg, "cpu")
    hv.vote_sites, fs.commit_sites = k1, k2
    try:
        pstate, flags = twin.init_pstate(2)
        pstate, flags = twin.step(pstate, flags, 0)
        trip = (counts["K1"], counts["K2"])
        counts.update(K1=0, K2=0)
        twin.boundary_votes(pstate)
        boundary = counts["K1"]
        with CountOps():
            twin.step(pstate, flags, 1)
    finally:
        hv.vote_sites, fs.commit_sites = real
    return trip, boundary, CountOps.ops


def case_label(name: str, strat, cfg: dict) -> str:
    """A case's label: region, strategy and its overrides (a list's first
    value)."""
    return " ".join([name, strat.__name__, *(
        f"-{k}" + (f"={v[0]}" if isinstance(v, tuple) else "")
        for k, v in cfg.items() if v)])


# Phases 19-24 rerun rows on the CPU in worker processes beside their card
# campaigns (the host's cores are otherwise idle while a campaign drives
# the card): ``cpu_rerun`` in the pool of ``rerun_pool()``, shut down
# after phase 24.
RERUNS: dict = {}


def rerun_pool():
    if "pool" not in RERUNS:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        RERUNS["pool"] = ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    return RERUNS["pool"]


def close_rerun_pool() -> None:
    RERUNS.pop("pool").shutdown()
    # The pool started multiprocessing's resource tracker, a child of this
    # script that would otherwise wait for its exit; closing its pipe ends
    # it (what ``ResourceTracker._stop`` does from Python 3.12.8 on).
    from multiprocessing import resource_tracker
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_fd", None) is not None:
        os.close(tracker._fd)
        os.waitpid(tracker._pid, 0)
        tracker._fd = tracker._pid = None


def cpu_rerun(name: str, strat, cfg: dict, sub, rows: int) -> dict:
    """The rows of schedule ``sub`` on a CPU build of region ``name`` under
    ``strat`` and ``cfg`` (plain voters and commit): column -> values."""
    import torch
    torch.set_num_threads(2)
    from coast_tpu_torch.inject.campaign import CampaignRunner
    from coast_tpu_torch.models import REGISTRY
    prog = strat(REGISTRY[name](), device="cpu", **cfg)
    res = CampaignRunner(prog).run_schedule(sub, batch_size=rows)
    return {col: getattr(res, col) for col in COLUMNS}


def region_cases(board: str, card: str, cases, CampaignRunner, hv, hc, fs,
                 n: int = 4096, cpu_rows: int = 256,
                 exempt=None, trip_log=None, batch: int = None,
                 seed: int = 1, engines=(False, True), sparse: bool = False,
                 dense_log=None) -> tuple:
    """Each case ``(region name, strategy, config overrides)`` on the
    card, ``n`` injections at ``batch`` (default ``n``), ``seed``, unfused
    and fused (``engines``): the records equal on every row (a float
    region's fused build is its unfused program); K1 launched exactly its
    per-trip count a loop trip plus the boundary group a batch, K2 (fused)
    exactly its per-trip count; with ``sparse``, a sparse campaign of the
    last engine equal to the dense one; the first ``cpu_rows`` rows rerun
    on the CPU (plain voters and commit, in ``rerun_pool()``, read after
    the last case), equal on every column outside
    ``exempt[name](leaf_order, leaf_id, bit)``.  Returns the (K1, K2)
    launches and {label: (inj/s, wall)}; ``trip_log`` (a dict), if given,
    gets each campaign's loop trips by (label, fused), ``dense_log`` each
    case's unfused dense result by label."""
    from coast_tpu_torch.models import REGISTRY
    device = "cpu" if board == "cpu" else "cuda"
    exempt = exempt or {}
    batch = batch or n
    batches = -(-n // batch)
    launches = [0, 0]
    rates = {}
    reruns = []
    for name, strat, cfg in cases:
        region = REGISTRY[name]()
        label = case_label(name, strat, cfg)
        results = {}
        for fused in engines:
            prog = strat(region, device=device, fuse_step=fused, **cfg)
            if (fused and prog._fuse_plan is None
                    and prog.fuse_plan_info.exact_dataflow):
                fail(f"{label}: no fused plan on an integer region")
            trip, boundary, ops = sync_launches(prog, hv, fs)
            trips = count_trips(prog)
            hv.LAUNCHES = hc.LAUNCHES = 0
            t0 = time.perf_counter()
            res = CampaignRunner(prog, strategy_name=strat.__name__).run(
                n, seed=seed, batch_size=batch)
            wall = time.perf_counter() - t0
            got = (hv.LAUNCHES, hc.LAUNCHES)
            want = (trip[0] * trips[0] + boundary * batches,
                    trip[1] * trips[0])
            if got != want:
                fail(f"{label} fused={fused}: K1/K2 launches {got}, not "
                     f"{want} ({trips[0]} trips of {trip}, boundary "
                     f"{boundary})")
            launches[0] += got[0]
            launches[1] += got[1]
            if trip_log is not None:
                trip_log[label, fused] = trips[0]
            results[fused] = res
            rates[f"{label}{' fused' if fused else ''}"] = (
                res.injections_per_sec, wall)
            log(f"{label}{' fused' if fused else ''}: {res.counts} "
                f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f} s, "
                f"{wall:.2f} s wall), {trips[0]} trips of {ops} torch ops "
                f"({1e6 * wall / (trips[0] * ops):.2f} us an op), K1 "
                f"{got[0]} ({trip[0]} a trip + {boundary} boundary), K2 "
                f"{got[1]} ({trip[1]} a trip) [{card}]")
            if sparse and fused == engines[-1]:
                hv.LAUNCHES = hc.LAUNCHES = 0
                res = CampaignRunner(prog, strategy_name=strat.__name__,
                                     collect="sparse").run(
                    n, seed=seed, batch_size=batch)
                launches[0] += hv.LAUNCHES
                launches[1] += hc.LAUNCHES
                why = records_differ(results[engines[0]], res)
                if why:
                    fail(f"{label}: sparse and dense records differ: {why}")
                rates[f"{label}{' fused' if fused else ''} sparse"] = (
                    res.injections_per_sec, res.seconds)
                log(f"{label}{' fused' if fused else ''} sparse = dense: "
                    f"{res.injections_per_sec:.1f} inj/s, transfer down "
                    f"{res.transfer['down']} B [{card}]")
        for fused in engines[1:]:
            why = records_differ(results[engines[0]], results[fused])
            if why:
                fail(f"{label}: fused and unfused records differ: {why}")
        dense = results[engines[0]]
        if dense_log is not None:
            dense_log[label] = dense
        sub = dense.schedule.slice(0, cpu_rows)
        skip = np.zeros(cpu_rows, bool)
        if name in exempt:
            skip = exempt[name](prog.leaf_order, sub.leaf_id, sub.bit)
        reruns.append((label, name, dense, skip, rerun_pool().submit(
            cpu_rerun, name, strat, cfg, sub, cpu_rows)))
    for label, name, dense, skip, rerun in reruns:
        cpu = rerun.result()
        differ = np.zeros(cpu_rows, bool)
        for col in COLUMNS:
            bad = getattr(dense, col)[:cpu_rows] != cpu[col]
            differ |= bad
            if (bad & ~skip).any():
                fail(f"{label}: {col} differs between card and CPU on rows "
                     f"{np.flatnonzero(bad & ~skip)[:10].tolist()}")
        if name in exempt:
            log(f"{label}: the first {cpu_rows} rows equal the CPU's "
                f"outside {int(skip.sum())} exempt rows "
                f"({int(differ.sum())} of them differ)")
    return tuple(launches), rates


def baseline_regions(work: Path, board: str, card: str, torch, TMR, DWC,
                     REGISTRY, CampaignRunner, hv, hc, fs,
                     n: int = 2048, cpu_rows: int = 256) -> tuple:
    """Phase 19: each BASELINE region (and quicksort under DWC) through
    ``region_cases``.  Then chstone_jpeg TMR through the supervisor CLI,
    with and without ``-pallasVoters`` (two processes started at the
    phase's start, so they overlap its campaigns): the runner's records
    and counts, and the same K1 launches.  Returns the (K1, K2)
    launches."""
    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.inject.supervisor import section_filter
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    clis = {}
    for extra in ("", " -pallasVoters"):
        cli_dir = work / f"jpeg_cli{extra.replace(' -', '_')}"
        cli_dir.mkdir()
        clis[extra] = (cli_dir, start_cli(
            ["-f", "chstone_jpeg", "-O", f"-TMR{extra}", "-t", str(n),
             "--batch-size", str(n), "--seed", "1", "--log-format",
             "ndjson", "-l", str(cli_dir)], board))
    cases = [(name, TMR, {}) for name in BASELINE] + [("quicksort", DWC, {})]
    got, rates = region_cases(board, card, cases, CampaignRunner, hv, hc, fs,
                              n=n, cpu_rows=cpu_rows)
    launches = list(got)
    log(f"phase 19 campaigns: fused = unfused on every row, the first "
        f"{cpu_rows} rows equal the CPU's, {time.perf_counter() - t_phase:.1f}"
        f" s [{card}]")

    # chstone_jpeg TMR through the supervisor CLI, with and without the
    # voter switch (C1), against the runner on the CLI's default section.
    prog = TMR(REGISTRY["chstone_jpeg"](), device=device)
    runner = CampaignRunner(prog, sections=section_filter(prog, "memory"),
                            strategy_name="TMR")
    hv.LAUNCHES = 0
    res = runner.run(n, seed=1, batch_size=n)
    launches[0] += hv.LAUNCHES
    ref_dir = work / "jpeg_runner"
    ref_dir.mkdir()
    logs.write_ndjson(res, runner.mmap, str(ref_dir / "runner.json"))
    want_rows = log_content(ref_dir, "ndjson")[1]
    cli_k1 = {}
    for extra, (cli_dir, proc) in clis.items():
        cli = finish_cli(proc, f"chstone_jpeg -TMR{extra} CLI")
        counts = {k: cli["summary"][k] for k in res.counts}
        if counts != res.counts:
            fail(f"chstone_jpeg -TMR{extra} CLI: counts {counts} differ "
                 f"from the runner's {res.counts}")
        if log_content(cli_dir, "ndjson")[1] != want_rows:
            fail(f"chstone_jpeg -TMR{extra} CLI: the per-injection log "
                 "differs from the runner's records")
        cli_k1[extra] = cli["k1"]
        launches[0] += cli["k1"]
        launches[1] += cli["k2"]
        log(f"chstone_jpeg -O '-TMR{extra}' through the supervisor CLI: "
            f"{counts}, the runner's records, "
            f"{cli['summary']['injections_per_sec']:.1f} inj/s in run "
            f"(overlapping the phase's campaigns), K1 {cli['k1']} "
            f"[{card}]")
    if cli_k1[""] != cli_k1[" -pallasVoters"] or cli_k1[""] <= 0:
        fail(f"-pallasVoters changed the K1 launches: {cli_k1}")
    log(json.dumps({"phase19_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "card": card}))
    return tuple(launches)


# Phase 20: the rest of the registry (ROADMAP item 12): the corner-case
# corpus, the float regions and towersOfHanoi with -protectStack.
CORPUS = ("trivial", "helloWorld", "simpleTMR", "crazyCF", "cache_test",
          "schedule2", "simd", "towersOfHanoi", "whetstone", "scalarize")
PROTECT_STACK = {"protect_stack": True, "no_store_data_sync": True}


def corpus_regions(work: Path, board: str, card: str, TMR, DWC, REGISTRY,
                   CampaignRunner, hv, hc, fs, n: int = 4096,
                   cpu_rows: int = 256) -> tuple:
    """Phase 20: the ten corpus regions under TMR, towersOfHanoi and
    scalarize under DWC too, and towersOfHanoi under ``-protectStack
    -noStoreDataSync``, through ``region_cases`` (whetstone's and
    scalarize's CPU comparison outside their models' ``order_sensitive``
    rows).  Then towersOfHanoi through the supervisor CLI with ``-TMR
    -protectStack -s stack`` (started at the phase's start): the runner's
    counts and log rows on the frame stack.  Returns the (K1, K2)
    launches."""
    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.inject.supervisor import section_filter
    from coast_tpu_torch.models import vector, whetstone
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    cli_dir = work / "hanoi_cli"
    cli_dir.mkdir()
    t0 = time.perf_counter()
    cli_proc = start_cli(["-f", "towersOfHanoi", "-O", "-TMR -protectStack",
                          "-s", "stack", "-t", str(n), "--batch-size",
                          str(n), "--seed", "1", "--log-format", "ndjson",
                          "-l", str(cli_dir)], board)
    cases = ([(name, TMR, {}) for name in CORPUS]
             + [("towersOfHanoi", DWC, {}), ("scalarize", DWC, {}),
                ("towersOfHanoi", TMR, PROTECT_STACK)])
    got, rates = region_cases(
        board, card, cases, CampaignRunner, hv, hc, fs, n=n,
        cpu_rows=cpu_rows, exempt={"whetstone": whetstone.order_sensitive,
                                   "scalarize": vector.order_sensitive})
    launches = list(got)
    log(f"phase 20 campaigns: fused = unfused on every row, the first "
        f"{cpu_rows} rows equal the CPU's outside the float exemptions, "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    prog = TMR(REGISTRY["towersOfHanoi"](), device=device,
               protect_stack=True)
    runner = CampaignRunner(prog, sections=section_filter(prog, "stack"),
                            strategy_name="TMR")
    hv.LAUNCHES = hc.LAUNCHES = 0
    res = runner.run(n, seed=1, batch_size=n)
    launches[0] += hv.LAUNCHES
    ref_dir = work / "hanoi_runner"
    ref_dir.mkdir()
    logs.write_ndjson(res, runner.mmap, str(ref_dir / "runner.json"))
    want_rows = log_content(ref_dir, "ndjson")[1]
    cli = finish_cli(cli_proc, "towersOfHanoi -TMR -protectStack -s stack CLI")
    wall = time.perf_counter() - t0
    counts = {k: cli["summary"][k] for k in res.counts}
    if counts != res.counts:
        fail(f"towersOfHanoi -s stack CLI: counts {counts} differ from the "
             f"runner's {res.counts}")
    if log_content(cli_dir, "ndjson")[1] != want_rows:
        fail("towersOfHanoi -s stack CLI: the per-injection log differs "
             "from the runner's records")
    if cli["k1"] <= 0:
        fail("towersOfHanoi -s stack CLI: launched K1 no time")
    launches[0] += cli["k1"]
    launches[1] += cli["k2"]
    log(f"towersOfHanoi -O '-TMR -protectStack' -s stack through the "
        f"supervisor CLI: {counts}, the runner's records, "
        f"{cli['summary']['injections_per_sec']:.1f} inj/s in run, "
        f"read {wall:.2f} s after its start at the phase's, K1 "
        f"{cli['k1']} [{card}]")
    log(json.dumps({"phase20_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "card": card}))
    return tuple(launches)


# Phase 21: BASELINE config 5, CFCSS stacked with TMR (-TMR -CFCSS).
CFCSS_REGIONS = ("matrixMultiply", "crc16", "chstone_mips", "crazyCF")


def cfcss_regions(board: str, card: str, TMR, REGISTRY, CampaignRunner, hv,
                  hc, fs, order_sensitive, n: int = 4096,
                  cpu_rows: int = 256) -> tuple:
    """Phase 21: matrixMultiply1024 under TMR+CFCSS, 512 injections at
    batch 128, seed 1, dense, every section: K1 launched exactly its
    per-trip count (a CPU twin's) a loop trip plus the boundary a batch,
    and the first 16 rows equal the CPU's outside the f32 exemption.  Then
    the integer regions under TMR+CFCSS through ``region_cases`` (unfused
    and fused, K1/K2 launches, ``cpu_rows`` rows against the CPU), and a
    ``sections=["cfcss"]`` campaign on matrixMultiply: detected or
    harmless, never an SDC, its first ``cpu_rows`` rows equal the CPU's.  Returns
    the (K1, K2) launches."""
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    region = REGISTRY["matrixMultiply1024"]()
    prog = TMR(region, device=device, cfcss=True)
    trip, boundary, _ = sync_launches(prog, hv, fs)
    trips = count_trips(prog)
    hv.LAUNCHES = hc.LAUNCHES = 0
    t0 = time.perf_counter()
    res = CampaignRunner(prog, strategy_name="TMR").run(512, seed=1,
                                                        batch_size=128)
    wall = time.perf_counter() - t0
    got = (hv.LAUNCHES, hc.LAUNCHES)
    want = (trip[0] * trips[0] + boundary * 4, trip[1] * trips[0])
    if got != want or got[0] <= 0:
        fail(f"matrixMultiply1024 TMR -CFCSS: K1/K2 launches {got}, not "
             f"{want} ({trips[0]} trips of {trip}, boundary {boundary} a "
             "batch)")
    if sum(v for k, v in res.counts.items() if k != "cache_invalid") \
            != res.n:
        fail(f"matrixMultiply1024 TMR -CFCSS counts do not sum to {res.n}")
    launches = list(got)
    sub = res.schedule.slice(0, 16)
    cpu_prog = TMR(region, device="cpu", cfcss=True)
    cpu = CampaignRunner(cpu_prog).run_schedule(sub, batch_size=16)
    exempt = order_sensitive(cpu_prog.leaf_order, sub.leaf_id, sub.bit)
    for col in COLUMNS:
        bad = getattr(res, col)[:16] != getattr(cpu, col)
        if (bad & ~exempt).any():
            fail(f"matrixMultiply1024 TMR -CFCSS: {col} differs between "
                 f"card and CPU on rows {np.flatnonzero(bad & ~exempt)}")
    log(f"matrixMultiply1024 TMR -CFCSS: {res.counts} "
        f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f} s, "
        f"{wall:.2f} s wall), K1 {got[0]} ({trip[0]} a trip over "
        f"{trips[0]} trips + {boundary} a batch), the first 16 rows equal "
        f"the CPU's outside {int(exempt.sum())} exempt rows [{card}]")

    got, rates = region_cases(
        board, card, [(name, TMR, {"cfcss": True}) for name in CFCSS_REGIONS],
        CampaignRunner, hv, hc, fs, n=n, cpu_rows=cpu_rows)
    launches[0] += got[0]
    launches[1] += got[1]
    if got[1] <= 0:
        fail("the fused TMR -CFCSS campaigns launched K2 no time")

    prog = TMR(REGISTRY["matrixMultiply"](), device=device, cfcss=True)
    hv.LAUNCHES = hc.LAUNCHES = 0
    sec = CampaignRunner(prog, sections=["cfcss"], strategy_name="TMR").run(
        n, seed=1, batch_size=n)
    launches[0] += hv.LAUNCHES
    if sec.counts["due_abort"] <= 0 or sec.counts["sdc"] != 0:
        fail(f"sections=['cfcss']: {sec.counts}: a CFCSS hit must be "
             "detected or harmless")
    sub = sec.schedule.slice(0, cpu_rows)
    cpu = CampaignRunner(TMR(REGISTRY["matrixMultiply"](), device="cpu",
                             cfcss=True)).run_schedule(sub,
                                                       batch_size=cpu_rows)
    for col in COLUMNS:
        if not np.array_equal(getattr(sec, col)[:cpu_rows],
                              getattr(cpu, col)):
            fail(f"sections=['cfcss']: {col} differs between card and CPU")
    log(f"matrixMultiply TMR -CFCSS sections=['cfcss']: {sec.counts} "
        f"{sec.injections_per_sec:.1f} inj/s, due_abort > 0 and no SDC, "
        f"the first {cpu_rows} rows equal the CPU's, K1 {hv.LAUNCHES} "
        f"[{card}]")
    log(f"phase 21: {time.perf_counter() - t_phase:.1f} s [{card}]")
    log(json.dumps({"phase21_inj_per_s": {
        **{k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "matrixMultiply1024 TMR -cfcss": [round(res.injections_per_sec, 1),
                                          round(wall, 3)]},
        "card": card}))
    return tuple(launches)


# Phase 22: function scope (nestedCalls under each class, rtos_app under
# its canonical config) and segmented scheduling.
SCOPE_CLASSES = {
    "default": {}, "ignoreFns": {"ignore_fns": ("fold",)},
    "skipLibCalls": {"skip_lib_calls": ("fold",)},
    "replicateFnCalls": {"replicate_fn_calls": ("fold",)},
    "protectedLibFn": {"protected_lib_fns": ("fold",)},
    "cloneAfterCall": {"clone_after_call_fns": ("fold",)},
    "cloneReturn": {"clone_return_fns": ("fold",)},
}
RTOS_CL = ["-cloneFns=run_mm,run_crc,heartbeat", "-protectedLibFn=ring_push",
           "-cloneAfterCall=rng_next", "-cloneGlbls=ring",
           f"-configFile={ROOT / 'rtos' / 'functions.config'}"]
SCOPE_KEYS = ("ignore_globals", "xmr_globals", "ignore_fns",
              "skip_lib_calls", "replicate_fn_calls", "clone_fns",
              "clone_return_fns", "clone_after_call_fns",
              "protected_lib_fns", "runtime_init_globals")


def call_launches(prog, hv) -> int:
    """The K1 launches one loop trip's call-boundary votes make on
    ``prog``, counted on a CPU twin (two rows, after a first trip)."""
    from coast_tpu_torch.interface import wrappers
    count = [0]
    real_vote, real_sites = wrappers._vote, hv.vote_sites
    inside = [False]

    def sites(group, n):
        count[0] += inside[0]
        return real_sites(group, n)

    def vote(sets, n):
        inside[0] = True
        try:
            return real_vote(sets, n)
        finally:
            inside[0] = False

    twin = type(prog)(prog.region, prog.cfg, "cpu")
    pstate, flags = twin.init_pstate(2)
    pstate, flags = twin.step(pstate, flags, 0)
    hv.vote_sites, wrappers._vote = sites, vote
    try:
        twin.step(pstate, flags, 1)
    finally:
        hv.vote_sites, wrappers._vote = real_sites, real_vote
    return count[0]


def scope_regions(work: Path, board: str, card: str, TMR, DWC, REGISTRY,
                  CampaignRunner, hv, hc, fs, n: int = 4096,
                  cpu_rows: int = 256) -> tuple:
    """Phase 22: nestedCalls under each of the seven function-scope
    classes, TMR and DWC, and rtos_app under its canonical config
    (``rtos/functions.config`` and ``rtos/Makefile``'s lists), through
    ``region_cases``, with the K1 launches of the call-boundary votes a
    trip; then ``-s`` (segmented) against ``-i`` on matrixMultiply and
    crc16 TMR, 4096 injections each: equal records; then
    ``-f matrixMultiply -O -TMR -CFCSS -s icache`` through the supervisor
    CLI on the card and on the host (both started at the phase's start):
    the same summary.  Returns the (K1, K2) launches."""
    from coast_tpu_torch.opt import build_overrides, parse_argv
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    argv = ["-f", "matrixMultiply", "-O", "-TMR", "-CFCSS", "-s", "icache",
            "-t", str(n), "--batch-size", str(n), "--seed", "1", "-q"]
    clis = {"card": start_cli(argv, board), "host": start_cli(argv, "cpu")}
    canonical = {k: v for k, v in build_overrides(
        parse_argv(RTOS_CL)[0]).items() if v and k in SCOPE_KEYS}
    cases = [("nestedCalls", strat, {**kw, "count_syncs": True})
             for kw in SCOPE_CLASSES.values() for strat in (TMR, DWC)]
    cases += [("rtos_app", strat, {**canonical, "count_syncs": True})
              for strat in (TMR, DWC)]
    trip_log = {}
    got, rates = region_cases(board, card, cases, CampaignRunner, hv, hc, fs,
                              n=n, cpu_rows=cpu_rows, trip_log=trip_log)
    launches = list(got)
    calls = {}
    for name, strat, cfg in cases:
        prog = strat(REGISTRY[name](), device=device, **cfg)
        per_trip = call_launches(prog, hv)
        label = case_label(name, strat, cfg)
        calls[label] = (per_trip, per_trip * trip_log[label, False],
                        per_trip * trip_log[label, True])
    for label, (per_trip, unfused, fused) in calls.items():
        log(f"{label}: {per_trip} call-boundary K1 launches a trip, "
            f"{unfused} unfused and {fused} fused")
    if sum(v[1] for v in calls.values()) <= 0:
        fail("no call-boundary vote launched K1")
    log(f"phase 22 scope campaigns: fused = unfused on every row, the first "
        f"{cpu_rows} rows equal the CPU's, "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")

    for name in ("matrixMultiply", "crc16"):
        results, ops = {}, {}
        for seg in (False, True):
            prog = TMR(REGISTRY[name](), device=device, segmented=seg)
            trip, boundary, ops[seg] = sync_launches(prog, hv, fs)
            trips = count_trips(prog)
            hv.LAUNCHES = hc.LAUNCHES = 0
            results[seg] = CampaignRunner(prog, strategy_name="TMR").run(
                n, seed=1, batch_size=n)
            if hv.LAUNCHES != trip[0] * trips[0] + boundary:
                fail(f"{name} TMR segmented={seg}: K1 launches "
                     f"{hv.LAUNCHES}, not {trip[0]} x {trips[0]} + "
                     f"{boundary}")
            launches[0] += hv.LAUNCHES
        why = records_differ(results[False], results[True])
        if why:
            fail(f"{name} TMR: -s and -i records differ: {why}")
        log(f"{name} TMR -s = -i on all {n} rows: {results[True].counts}; "
            f"-i {results[False].injections_per_sec:.1f} inj/s, "
            f"{ops[False]} torch ops a trip; -s "
            f"{results[True].injections_per_sec:.1f} inj/s, {ops[True]} "
            f"torch ops a trip [{card}]")

    cli = finish_cli(clis["card"], "matrixMultiply -TMR -CFCSS -s icache CLI")
    host = finish_cli(clis["host"], "matrixMultiply -TMR -CFCSS -s icache "
                      "CLI on the host")
    if steady(cli["summary"]) != steady(host["summary"]):
        fail(f"-TMR -CFCSS -s icache: the card's summary "
             f"{steady(cli['summary'])} differs from the host's "
             f"{steady(host['summary'])}")
    if cli["k1"] <= 0:
        fail("-TMR -CFCSS -s icache CLI: launched K1 no time")
    launches[0] += cli["k1"]
    launches[1] += cli["k2"]
    log(f"matrixMultiply -O '-TMR -CFCSS' -s icache through the supervisor "
        f"CLI: {steady(cli['summary'])}, the host's summary, "
        f"{cli['summary']['injections_per_sec']:.1f} inj/s, K1 {cli['k1']} "
        f"[{card}]")
    log(json.dumps({"phase22_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "call_boundary_k1": calls, "card": card}))
    return tuple(launches)


# Phase 23: the preemptive RTOS kernel targets (ROADMAP item 15) under
# their canonical config (rtos/Makefile's lists plus rtos/kernel.config).
RTOS_TARGETS = ("rtos_mm", "rtos_kUser")


def rtos_kernel_targets(work: Path, board: str, card: str, TMR, DWC,
                        REGISTRY, CampaignRunner, hv, hc, fs,
                        n: int = 8192, batch: int = 4096, seed: int = 42,
                        cpu_rows: int = 256) -> tuple:
    """Phase 23: rtos_mm and rtos_kUser under the canonical config, TMR
    and DWC: fault-free rows clean, unfused and fused; then ``n``
    injections at ``batch``, seed ``seed``, through ``region_cases``
    (fused = unfused, sparse = dense, K1/K2 launches a trip, ``cpu_rows``
    rows against the CPU), each with DUE_STACK_OVERFLOW and DUE_ASSERT rows and
    its counts rolled up over ``rtos_sections``; the reference's recorded
    canonical campaign (``artifacts/rtos_campaign.json``: rtos_mm TMR,
    2,048 rows at 256, seed 42) rerun on the card, its counts equal; then
    ``-f rtos_mm -O '-TMR <canonical>' -s stack`` through the supervisor
    CLI (started at the phase's start) against the runner.  Returns the
    (K1, K2) launches."""
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.inject.supervisor import section_filter
    from coast_tpu_torch.rtos import campaign as rc
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    launches = [0, 0]
    cli_name = "rtos_mm"
    flags = " ".join(f"-{k}={','.join(v)}"
                     for k, v in rc.CL_LISTS[cli_name].items())
    opt = f"-TMR {flags} -configFile={ROOT / 'rtos' / 'kernel.config'}"
    cli_dir = work / "rtos_cli"
    cli_dir.mkdir()
    cli_proc = start_cli(["-f", cli_name, "-O", opt, "-s", "stack", "-t",
                          "4096", "--batch-size", "4096", "--seed",
                          str(seed), "--log-format", "ndjson", "-l",
                          str(cli_dir)], board)
    for name in RTOS_TARGETS:
        for strat in (TMR, DWC):
            for fused in (False, True):
                prog = strat(REGISTRY[name](), device=device,
                             fuse_step=fused, **rc.canonical_overrides(name))
                hv.LAUNCHES = hc.LAUNCHES = 0
                rec = prog.run_batch(batch=batch)
                launches[0] += hv.LAUNCHES
                launches[1] += hc.LAUNCHES
                codes = cls.classify(rec, prog.output_words)
                if not ((codes == cls.SUCCESS).all()
                        and (rec["steps"] == prog.region.nominal_steps).all()
                        and not rec["stack_fault"].any()
                        and not rec["assert_fault"].any()):
                    fail(f"{name} {strat.__name__} fused={fused}: a "
                         "fault-free row is not clean")
    log(f"phase 23: fault-free rtos_mm and rtos_kUser rows clean, TMR and "
        f"DWC, unfused and fused, {batch} rows each [{card}]")

    cases = [(name, strat, rc.canonical_overrides(name))
             for name in RTOS_TARGETS for strat in (TMR, DWC)]
    dense = {}
    got, rates = region_cases(board, card, cases, CampaignRunner, hv, hc, fs,
                              n=n, batch=batch, seed=seed, cpu_rows=cpu_rows,
                              sparse=True, dense_log=dense)
    launches[0] += got[0]
    launches[1] += got[1]
    sections = {}
    for (name, strat, cfg), label in zip(cases, dense):
        res = dense[label]
        if not (res.counts["due_stack_overflow"] and
                res.counts["due_assert"]):
            fail(f"{label}: no stack-overflow or no assert DUE in "
                 f"{res.counts}")
        prog = strat(REGISTRY[name](), device="cpu", **cfg)
        table = rc.category_table(res, CampaignRunner(prog).mmap,
                                  prog.region.meta["rtos_sections"])
        sections[label] = {cat: {k: v for k, v in row.items() if v}
                           for cat, row in table.items()}
        log(f"{label}: DUE sub-buckets {rc.due_sub_buckets(res.counts)}; "
            f"by rtos section {sections[label]}")

    # The reference's recorded canonical campaign, read as data.
    with open(ROOT / "artifacts" / "rtos_campaign.json") as fh:
        recorded = json.load(fh)
    prog = rc.canonical_prog(recorded["benchmark"], 3, device)
    hv.LAUNCHES = hc.LAUNCHES = 0
    res = CampaignRunner(prog, strategy_name="TMR").run(
        recorded["injections"], seed=recorded["seed"], batch_size=256)
    launches[0] += hv.LAUNCHES
    log(f"the reference's recorded {recorded['benchmark']} campaign "
        f"({recorded['injections']} rows, seed {recorded['seed']}): "
        f"{recorded['counts']}; on the card: {res.counts} [{card}]")
    if res.counts != recorded["counts"]:
        fail("the canonical rtos_mm campaign's counts differ from the "
             "reference's recorded ones")

    # -s stack through the supervisor CLI.
    prog = rc.canonical_prog(cli_name, 3, device)
    runner = CampaignRunner(prog, sections=section_filter(prog, "stack"),
                            strategy_name="TMR")
    hv.LAUNCHES = hc.LAUNCHES = 0
    res = runner.run(4096, seed=seed, batch_size=4096)
    launches[0] += hv.LAUNCHES
    ref_dir = work / "rtos_runner"
    ref_dir.mkdir()
    logs.write_ndjson(res, runner.mmap, str(ref_dir / "runner.json"))
    want_rows = log_content(ref_dir, "ndjson")[1]
    cli = finish_cli(cli_proc, f"{cli_name} -TMR -s stack CLI")
    wall = time.perf_counter() - t_phase
    counts = {k: cli["summary"][k] for k in res.counts}
    if counts != res.counts:
        fail(f"{cli_name} -s stack CLI: counts {counts} differ from the "
             f"runner's {res.counts}")
    if log_content(cli_dir, "ndjson")[1] != want_rows:
        fail(f"{cli_name} -s stack CLI: the per-injection log differs from "
             "the runner's records")
    if cli["k1"] <= 0 or counts["due_stack_overflow"] <= 0:
        fail(f"{cli_name} -s stack CLI: K1 {cli['k1']}, counts {counts}")
    launches[0] += cli["k1"]
    launches[1] += cli["k2"]
    log(f"{cli_name} -O '-TMR <canonical>' -s stack through the supervisor "
        f"CLI: {counts}, the runner's records, "
        f"{cli['summary']['injections_per_sec']:.1f} inj/s in run, read "
        f"{wall:.2f} s after its start at the phase's, K1 {cli['k1']} "
        f"[{card}]")
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s [{card}]")
    log(json.dumps({"phase23_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "rtos_sections": sections, "card": card}))
    return tuple(launches)


# Phase 24: the protected training step (ROADMAP item 14).
TRAIN_REGIONS = ("train_mlp", "train_mlp_adam")
TRAIN_RTOL = 1e-5


def train_regions(board: str, card: str, torch, DWC, TMR, unprotected,
                  REGISTRY, CampaignRunner, hv, hc, fs, n: int = 16384,
                  batch: int = 4096, seed: int = 11,
                  cpu_rows: int = 256) -> tuple:
    """Phase 24: train_mlp and train_mlp_adam.  The card's golden loss
    trajectory against the host's (within ``TRAIN_RTOL``; the weights bit
    for bit); fault-free rows at batch 1 and ``batch`` classify success
    under unprotected, DWC, TMR and selective xMR; then ``n`` injections
    at ``batch``, seed ``seed``, unprotected and selective (``n // 4``
    under DWC and TMR) through ``region_cases`` (the float regions run
    unfused; K1 launches a trip; 256 rows against the CPU): the
    unprotected campaign has train_self_heal and train_sdc rows and no raw
    sdc, the selective one corrected rows and fewer train_sdc.  Returns
    the (K1, K2) launches."""
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.train import mlp
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    strategies = (unprotected, DWC, TMR, mlp.selective_xmr)
    launches = [0, 0]
    for name in TRAIN_REGIONS:
        optimizer = REGISTRY[name]().meta["train"]["optimizer"]
        gold, host = mlp.golden(optimizer, device), mlp.golden(optimizer,
                                                               "cpu")
        rel = float(np.max(np.abs(gold["losses"] - host["losses"])
                           / np.abs(host["losses"])))
        same = all(gold["params"][k].tobytes() == host["params"][k].tobytes()
                   for k in gold["params"])
        if rel > TRAIN_RTOL or not gold["losses"][-1] < gold["losses"][0]:
            fail(f"{name}: the card's loss trajectory {gold['losses']} is "
                 f"not within {TRAIN_RTOL} of the host's {host['losses']}")
        if not same:
            fail(f"{name}: the card's golden weights differ from the host's")
        log(f"{name}: golden losses {gold['losses'][0]:.6f} -> "
            f"{gold['losses'][-1]:.6f}, max relative difference to the "
            f"host's {rel:.3g}, weights bit-equal [{card}]")
        for strat in strategies:
            prog = strat(REGISTRY[name](), device=device)
            for rows in (1, batch):
                hv.LAUNCHES = 0
                rec = prog.run_batch(batch=rows)
                launches[0] += hv.LAUNCHES
                codes = cls.classify(rec, prog.output_words)
                if not ((codes == cls.SUCCESS).all()
                        and (rec["train_probe"] == 0).all()):
                    hist = np.bincount(codes.cpu().numpy(),
                                       minlength=cls.NUM_CLASSES)
                    fail(f"{name} {strat.__name__} batch {rows}: fault-free "
                         f"classes {hist.tolist()}, not all success")
    log(f"phase 24: fault-free rows success at batch 1 and {batch} under "
        f"every strategy [{card}]")

    # Unprotected and selective at ``n`` (their counts are compared), DWC
    # and TMR at a quarter of it (the script's time limit).
    dense, rates = {}, {}
    for picked, rows in (((unprotected, mlp.selective_xmr), n),
                         ((DWC, TMR), n // 4)):
        cases = [(name, strat, {}) for name in TRAIN_REGIONS
                 for strat in picked]
        got, more = region_cases(board, card, cases, CampaignRunner, hv, hc,
                                 fs, n=rows, batch=batch, seed=seed,
                                 cpu_rows=cpu_rows, engines=(False,),
                                 dense_log=dense)
        rates.update(more)
        launches[0] += got[0]
        launches[1] += got[1]
    for name in TRAIN_REGIONS:
        unprot = dense[case_label(name, unprotected, {})].counts
        sel = dense[case_label(name, mlp.selective_xmr, {})].counts
        if not (unprot["train_self_heal"] and unprot["train_sdc"]
                and unprot["sdc"] == 0):
            fail(f"{name} unprotected: {unprot}")
        if not (sel["corrected"] > 0
                and sel["train_sdc"] < unprot["train_sdc"]):
            fail(f"{name} selective_xmr: {sel} against unprotected {unprot}")
        log(f"{name}: unprotected train_self_heal {unprot['train_self_heal']}"
            f" train_sdc {unprot['train_sdc']}; selective corrected "
            f"{sel['corrected']} train_sdc {sel['train_sdc']} [{card}]")
    log(f"phase 24: {time.perf_counter() - t_phase:.1f} s [{card}]")
    log(json.dumps({"phase24_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "counts": {k: v.counts for k, v in dense.items()}, "card": card}))
    return tuple(launches)


# Phase 25: the sharded stencil.  Both voter placements, the single-site
# and the link fault models.
STENCIL_MODELS = ("single", "link")
# Runs the multi-process worker as ``python -m
# coast_tpu_torch.parallel.multihost`` does, reporting its launches at exit.
WORKER = SUPERVISOR.replace("coast_tpu_torch.inject.supervisor",
                            "coast_tpu_torch.parallel.multihost")


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sharded_stencil(work: Path, board: str, card: str, torch, TMR, DWC,
                    CampaignRunner, hv, hc, fs, n: int = 8192,
                    batch: int = 4096, cpu_rows: int = 256) -> tuple:
    """Phase 25: the sharded backend on the stencil.  (a) fault-free rows
    clean under TMR and DWC, both placements, unfused and fused;
    ``run_distributed`` over a one-device mesh and a two-shard mesh on
    cuda:0 equal to ``golden_trajectory``.  (b) the recorded study
    (``artifacts/stencil_campaign.json``, read as data) on the card: its
    counts, SDC sections, blast radii, two-shard ledgers and containment
    block.  (c) ``n`` injections at ``batch``, both placements, single and
    link models: the single-device runner unfused and fused, a one-device
    mesh and a two-shard mesh on cuda:0, dense and sparse, and
    ``run_histogram`` on both meshes, all with equal codes and counts; K1
    and K2 launched their per-trip counts (a CPU twin); the first
    ``cpu_rows`` rows equal the CPU's.  (d) the supervisor CLI with
    ``--mesh 1 -f stencil --placement link --fault-model link -s
    interconnect``: the runner's summary with its mesh block; ``--mesh 2``
    exits 1 on a one-card machine.  (e) a one-rank nccl worker prints the
    one-device mesh's ``run_histogram`` counts.  The processes of (d) and
    (e) start at the phase's start.  Returns the (K1, K2) launches."""
    from coast_tpu_torch.inject import classify as cls
    from coast_tpu_torch.inject.schedule import FaultModel
    from coast_tpu_torch.inject.supervisor import section_filter
    from coast_tpu_torch.models import stencil
    from coast_tpu_torch.parallel.mesh import Mesh, make_mesh
    device = "cpu" if board == "cpu" else "cuda"
    t_phase = time.perf_counter()
    launches = [0, 0]
    one = make_mesh(1, device=device)
    two = Mesh([torch.device(device, 0) if device == "cuda"
                else torch.device("cpu")] * 2)
    # (d)'s and (e)'s processes start here, beside (a)-(c).
    argv = ["-f", "stencil", "--placement", "link", "--fault-model", "link",
            "-s", "interconnect", "-t", str(n), "--batch-size", str(batch),
            "-q"]
    procs = {"mesh 1": start_cli([*argv, "--mesh", "1"], board)}
    if board == "gpu" and torch.cuda.device_count() < 2:
        procs["mesh 2"] = start_cli([*argv, "--mesh", "2"], board)
    if board == "gpu":
        procs["nccl"] = spawn(
            [sys.executable, "-c", WORKER, "stencil", "--coordinator",
             f"127.0.0.1:{free_port()}", "--num-processes", "1",
             "--process-id", "0", "-e", str(n), "--seed", "21"],
            cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    # (a) Fault-free rows and the distributed executor.
    for placement in stencil.PLACEMENTS:
        for strat in (TMR, DWC):
            for fused in (False, True):
                prog = strat(stencil.make_region(placement), device=device,
                             fuse_step=fused)
                hv.LAUNCHES = hc.LAUNCHES = 0
                rec = prog.run_batch(batch=batch)
                launches[0] += hv.LAUNCHES
                launches[1] += hc.LAUNCHES
                codes = cls.classify(rec, prog.output_words)
                if not ((codes == cls.SUCCESS).all()
                        and (rec["steps"] == prog.region.nominal_steps).all()
                        and not rec["dwc_fault"].any()
                        and not rec["corrected"].any()):
                    fail(f"stencil[{placement}] {strat.__name__} "
                         f"fused={fused}: a fault-free row is not clean")
    golden = stencil.golden_trajectory()
    for mesh in (one, two):
        if not np.array_equal(stencil.run_distributed(mesh=mesh), golden):
            fail(f"run_distributed over {mesh} differs from the golden")
    log(f"phase 25: fault-free stencil rows clean (TMR, DWC, both "
        f"placements, unfused and fused, {batch} rows each); "
        f"run_distributed over {one} and {two} = golden_trajectory [{card}]")

    # (b) The recorded containment study.
    with open(ROOT / "artifacts" / "stencil_campaign.json") as fh:
        art = json.load(fh)
    hv.LAUNCHES = hc.LAUNCHES = 0
    doc = stencil.containment_study(device=device, mesh=two, n=art["n"],
                                    seed=art["seed"])
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    if not doc["ok"] or doc["containment"] != art["containment"]:
        fail(f"stencil study: {doc['failures']}, containment "
             f"{doc['containment']} vs recorded {art['containment']}")
    for placement, pl in art["placements"].items():
        for spec, cell in pl["cells"].items():
            got = doc["placements"][placement]["cells"][spec]
            for key in ("counts", "sdc", "sdc_by_section", "blast_radius",
                        "sharded_parity", "mesh"):
                if got[key] != cell[key]:
                    fail(f"stencil study {placement}/{spec}: {key} "
                         f"{got[key]} vs recorded {cell[key]}")
    log(f"phase 25: the recorded stencil study on the card: every cell's "
        f"counts, blast radius and two-shard ledger, containment "
        f"{doc['containment']} [{card}]")

    # (c) ``n`` injections, every runner form.
    rates = {}
    for placement in stencil.PLACEMENTS:
        region = stencil.make_region(placement)
        for spec in STENCIL_MODELS:
            model = FaultModel.parse(spec)
            label = f"stencil[{placement}] TMR {spec}"
            results = {}
            for fused in (False, True):
                prog = TMR(region, device=device, fuse_step=fused)
                trip, boundary, ops = sync_launches(prog, hv, fs)
                trips = count_trips(prog)
                hv.LAUNCHES = hc.LAUNCHES = 0
                res = CampaignRunner(prog, strategy_name="TMR",
                                     fault_model=model).run(
                    n, seed=1, batch_size=batch)
                got = (hv.LAUNCHES, hc.LAUNCHES)
                want = (trip[0] * trips[0] + boundary * (n // batch),
                        trip[1] * trips[0])
                if got != want:
                    fail(f"{label} fused={fused}: K1/K2 launches {got}, not "
                         f"{want} ({trips[0]} trips of {trip}, boundary "
                         f"{boundary})")
                launches[0] += got[0]
                launches[1] += got[1]
                results[f"single fused={fused}"] = res
                rates[f"{label}{' fused' if fused else ''}"] = (
                    res.injections_per_sec, res.seconds)
                log(f"{label}{' fused' if fused else ''}: {res.counts} "
                    f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f}"
                    f" s), {trips[0]} trips of {ops} torch ops, K1 {got[0]} "
                    f"({trip[0]} a trip + {boundary} boundary), K2 {got[1]} "
                    f"({trip[1]} a trip) [{card}]")
            base = results["single fused=False"]
            why = records_differ(base, results["single fused=True"])
            if why:
                fail(f"{label}: fused and unfused records differ: {why}")
            for mesh_name, mesh in (("one-device mesh", one),
                                    ("two-shard mesh", two)):
                for collect in ("dense", "sparse"):
                    hv.LAUNCHES = hc.LAUNCHES = 0
                    res = CampaignRunner(prog, mesh=mesh, strategy_name="TMR",
                                         fault_model=model,
                                         collect=collect).run(
                        n, seed=1, batch_size=batch)
                    launches[0] += hv.LAUNCHES
                    launches[1] += hc.LAUNCHES
                    why = records_differ(base, res)
                    block = res.summary()["mesh"]
                    if why or sum(block["per_shard_interesting"]) != int(
                            np.sum(base.codes > cls.CORRECTED)):
                        fail(f"{label} {mesh_name} {collect}: {why or block}")
                    rates[f"{label} fused {mesh_name} {collect}"] = (
                        res.injections_per_sec, res.seconds)
                    log(f"{label} fused, {mesh_name} {collect} = single "
                        f"device: {res.injections_per_sec:.1f} inj/s "
                        f"({res.seconds:.2f} s), ledger "
                        f"{block['per_shard_interesting']}, K1 {hv.LAUNCHES} "
                        f"K2 {hc.LAUNCHES} [{card}]")
                runner = CampaignRunner(prog, mesh=mesh, fault_model=model)
                hv.LAUNCHES = hc.LAUNCHES = 0
                t0 = time.perf_counter()
                hist = runner.run_histogram(n, seed=1, batch_size=batch)
                wall = time.perf_counter() - t0
                launches[0] += hv.LAUNCHES
                launches[1] += hc.LAUNCHES
                if hist != base.counts:
                    fail(f"{label} {mesh_name} run_histogram {hist} vs "
                         f"{base.counts}")
                rates[f"{label} fused {mesh_name} run_histogram"] = (
                    n / wall, wall)
                log(f"{label} fused, {mesh_name} run_histogram = counts: "
                    f"{n / wall:.1f} inj/s ({wall:.2f} s) [{card}]")
            sub = base.schedule.slice(0, cpu_rows)
            cpu = CampaignRunner(TMR(region, device="cpu")).run_schedule(
                sub, batch_size=cpu_rows)
            for col in COLUMNS:
                if not np.array_equal(getattr(base, col)[:cpu_rows],
                                      getattr(cpu, col)):
                    fail(f"{label}: {col} differs between card and CPU")
            log(f"{label}: the first {cpu_rows} rows equal the CPU's")

    # (d) The supervisor CLI with --mesh and --placement.
    prog = TMR(stencil.make_region("link"), device=device)
    hv.LAUNCHES = hc.LAUNCHES = 0
    want = CampaignRunner(prog, sections=section_filter(prog, "interconnect"),
                          strategy_name="TMR", mesh=one,
                          fault_model=FaultModel.link()).run(
        n, seed=0, batch_size=batch).summary()
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    cli = finish_cli(procs["mesh 1"], "stencil --mesh 1 CLI")
    wall = time.perf_counter() - t_phase
    launches[0] += cli["k1"]
    launches[1] += cli["k2"]
    if steady(cli["summary"]) != steady(want) or "mesh" not in want:
        fail(f"stencil --mesh 1 CLI: {steady(cli['summary'])} vs the "
             f"runner's {steady(want)}")
    log(f"stencil --placement link --fault-model link -s interconnect "
        f"--mesh 1 through the supervisor CLI: the runner's summary "
        f"(mesh {want['mesh']}), {cli['summary']['injections_per_sec']:.1f}"
        f" inj/s in run, read {wall:.2f} s after its start, K1 "
        f"{cli['k1']} K2 {cli['k2']} [{card}]")
    if "mesh 2" in procs:
        cli = finish_cli(procs["mesh 2"], "stencil --mesh 2 CLI",
                         expect_ok=False)
        if cli["rc"] != 1 or "wants more devices" not in cli["err"]:
            fail(f"--mesh 2 on a one-card machine exited {cli['rc']}: "
                 f"{cli['err'][-500:]}")
        why = next(ln for ln in cli["err"].splitlines()
                   if "wants more devices" in ln)
        log(f"--mesh 2 on a one-card machine exits 1: {why}")

    # (e) A one-rank nccl worker.
    if board == "gpu":
        hv.LAUNCHES = hc.LAUNCHES = 0
        want = CampaignRunner(TMR(stencil.make_region(), device=device),
                              mesh=one).run_histogram(n, seed=21,
                                                      batch_size=1024)
        launches[0] += hv.LAUNCHES
        launches[1] += hc.LAUNCHES
        worker = finish_cli(procs["nccl"], "the one-rank nccl worker",
                            timeout=300)
        wall = time.perf_counter() - t_phase
        launches[0] += worker["k1"]
        launches[1] += worker["k2"]
        line = next((ln for ln in worker["out"].splitlines()
                     if "counts=" in ln), "")
        if (not line.startswith("[proc 0/1] devices=1 ")
                or line.split("counts=", 1)[1] != str(want)):
            fail(f"the nccl worker printed {line!r}, want counts {want}")
        log(f"one-rank nccl worker: {line}, = run_histogram; read "
            f"{wall:.2f} s after its start, K1 {worker['k1']} K2 "
            f"{worker['k2']} [{card}]")
    log(f"phase 25: {time.perf_counter() - t_phase:.1f} s [{card}]")
    log(json.dumps({"phase25_inj_per_s": {
        k: [round(v[0], 1), round(v[1], 3)] for k, v in rates.items()},
        "card": card}))
    return tuple(launches)


# Phase 26: the programs lint_program holds on the card, with the
# sweep artifact's strategy for each (None: compared with the CPU only).
LINT_ON_CARD = (("matrixMultiply", "TMR", {}), ("matrixMultiply", "DWC", {}),
                ("crc16", "TMR", {"fuse_step": True}),
                ("matrixMultiply1024", "TMR", {}), ("rtos_mm", "TMR", {}),
                ("train_mlp", "TMR", {}))


def parse_and_lint(work: Path, card: str, TMR, DWC, REGISTRY,
                   CampaignRunner, hv, hc, bare: dict,
                   n: int = 16384) -> tuple:
    """Phase 26: the log parser and the linter on the card.  (a) Phase 9's
    10^6-row dense campaign (``bare``, run on the card) as a fresh ndjson
    log, summarised by the native classifier, its counts equal the
    campaign's; a ``n``-row crc16 TMR card campaign in every format,
    dense and sparse, ``.gz`` included, summarised by the Python path,
    counts equal.  (b) ``lint_program`` with survival on the card for
    ``LINT_ON_CARD``: findings equal the same call's on the CPU and the
    recorded sweep's; ``preflight="static"`` refuses a lane-averaging
    mutant built on the card.  (c) a crc16 TMR campaign at ``unroll=2``
    equals one at ``unroll=1``, record for record.  Returns the (K1, K2)
    launches of the lint probes and the campaigns."""
    from coast_tpu_torch import native
    from coast_tpu_torch.analysis import json_parser as jp
    from coast_tpu_torch.analysis import lint
    from coast_tpu_torch.inject import logs
    t_phase = time.perf_counter()
    launches = [0, 0]

    # (a) The parser: native at 10^6 rows, Python at n rows.
    res, mmap = bare["dense"], CampaignRunner(
        TMR(REGISTRY["matrixMultiply"]())).mmap
    path = work / "parse_1e6.ndjson.json"
    t0 = time.perf_counter()
    logs.write_ndjson(res, mmap, str(path))
    wrote = time.perf_counter() - t0
    before = native.CLASSIFIED_LINES
    t0 = time.perf_counter()
    summary = jp.summarize_path(str(path))
    secs = time.perf_counter() - t0
    if native.CLASSIFIED_LINES - before != res.n:
        fail(f"phase 26: the 10^6-row log took the Python path "
             f"({native.CLASSIFIED_LINES - before} native lines)")
    counts = {k: v for k, v in res.counts.items() if k in summary.counts}
    if summary.n != res.n or any(summary.counts[k] != v
                                 for k, v in counts.items()):
        fail(f"phase 26: the native summary {summary.n} {summary.counts} "
             f"differs from the campaign's {res.counts}")
    path.unlink()
    log(f"parser: {res.n} dense ndjson rows written in {wrote:.2f} s, "
        f"summarised by the native classifier in {secs:.2f} s "
        f"({res.n / secs:.1f} rows/s), counts equal the campaign's [{card}]")
    hv.LAUNCHES = hc.LAUNCHES = 0
    py_secs = {}
    for collect in ("dense", "sparse"):
        runner = CampaignRunner(TMR(REGISTRY["crc16"]()), strategy_name="TMR",
                                collect=collect)
        got = runner.run(n, seed=5, batch_size=n)
        for writer in ("write_json", "write_ndjson", "write_columnar"):
            for gz in ("", ".gz"):
                out = work / f"parse_{collect}_{writer}.json{gz}"
                getattr(logs, writer)(got, runner.mmap, str(out))
                t0 = time.perf_counter()
                s = jp.summarize_runs(out.name, (
                    doc for _, doc in jp._iter_docs(str(out))))
                py_secs[f"{collect} {writer}{gz}"] = round(
                    time.perf_counter() - t0, 3)
                if s.n != got.n or any(s.counts[k] != v
                                       for k, v in got.counts.items()
                                       if k in s.counts):
                    fail(f"phase 26: Python summary of {out.name} "
                         f"{s.n} {s.counts} differs from {got.counts}")
                out.unlink()
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    log(f"parser: crc16 TMR {n} rows, dense and sparse, json/ndjson/"
        f"columnar, plain and .gz: the Python path's counts equal the "
        f"campaign's; seconds {py_secs} [{card}]")

    # (b) The linter with survival on the card.
    with open(ROOT / "artifacts" / "lint_sweep.json") as fh:
        recorded = json.load(fh)["benchmarks"]
    make = {"TMR": TMR, "DWC": DWC}
    probe_launches = {}
    for name, strat, kw in LINT_ON_CARD:
        hv.LAUNCHES = hc.LAUNCHES = 0
        t0 = time.perf_counter()
        report = lint.lint_program(make[strat](REGISTRY[name](), **kw),
                                   strategy=strat)
        secs = time.perf_counter() - t0
        probe = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += probe[0]
        launches[1] += probe[1]
        if probe[0] + probe[1] <= 0:
            fail(f"phase 26: the {name} {strat} lint probe launched no "
                 "kernel")
        got = {(f.rule, f.severity, f.locus) for f in report.findings}
        cpu = lint.lint_program(make[strat](REGISTRY[name](), device="cpu",
                                            **kw), strategy=strat)
        want = {(f.rule, f.severity, f.locus) for f in cpu.findings}
        if got != want or not report.ok:
            fail(f"phase 26: {name} {strat} {kw} lint on the card {got} "
                 f"differs from the CPU's {want} (ok {report.ok})")
        if not kw:
            sweep = {(f["rule"], f["severity"], f["locus"])
                     for f in recorded[name][strat]["findings"]}
            if got != sweep:
                fail(f"phase 26: {name} {strat} lint {got} differs from "
                     f"the recorded sweep's {sweep}")
        label = name + (" fused" if kw else "") + " " + strat
        probe_launches[label] = probe
        log(f"lint {label} on the card: {len(got)} finding(s), equal to the "
            f"CPU's{'' if kw else ' and the sweep' + chr(39) + 's'}, "
            f"{secs:.2f} s, probe K1 {probe[0]} K2 {probe[1]} launches "
            f"[{card}]")
    prog = TMR(REGISTRY["crc16"]())
    orig = prog.step

    def averaged(pstate, flags, t):
        new_state, flags = orig(pstate, flags, t)
        crc = new_state["crc"]
        avg = (crc.sum(dim=1) // 3).to(crc.dtype)
        return {**new_state, "crc": avg.unsqueeze(1).expand(
            crc.shape).contiguous()}, flags

    prog.step = averaged
    try:
        CampaignRunner(prog, preflight="static")
    except lint.ReplicationLintError as e:
        if "lane-collapse" not in str(e):
            fail(f"phase 26: the lane-averaging mutant was refused for "
                 f"another reason: {e}")
    else:
        fail("phase 26: preflight='static' let a lane-averaging mutant "
             "through on the card")
    log("lint: preflight='static' refuses the lane-averaging crc16 mutant "
        "built on the card (lane-collapse)")

    # (c) --unroll: the record does not change.
    hv.LAUNCHES = hc.LAUNCHES = 0
    prog = TMR(REGISTRY["crc16"]())
    one = CampaignRunner(prog, unroll=1).run(n, seed=7, batch_size=n)
    two = CampaignRunner(prog, unroll=2).run(n, seed=7, batch_size=n)
    why = records_differ(one, two)
    if why:
        fail(f"phase 26: crc16 TMR at unroll=2 differs from unroll=1: {why}")
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    log(f"crc16 TMR {n} rows at unroll=2 = unroll=1, record for record "
        f"({one.counts}); phase 26 in {time.perf_counter() - t_phase:.1f} s"
        f" [{card}]")
    return tuple(launches)


# The reference's recorded parity study (artifacts/equiv_study.json, read as
# data): 16,384 injections at seed 2026 a cell.
EQUIV_CELLS = (("matrixMultiply", "TMR"), ("matrixMultiply", "DWC"),
               ("crc16", "TMR"), ("crc16", "DWC"))


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def ftz_split_classes(runner, ex, red) -> int:
    """The classes of an exhaustive campaign ``ex`` whose rows classify
    differently, each explained or a failure.  A reduced row must equal
    the exhaustive row it represents.  A class may mix outcomes only where
    the merge argument meets the compare's flush to zero: an unwritten
    float32 leaf (``free``/``lt``) whose word is zero, where a mantissa or
    sign flip reads as zero in every vote while an exponent flip does not.
    Returns the number of rows in such classes."""
    import torch
    part, prog = runner.equiv_partition, runner.prog
    keys = part.class_keys(ex.schedule)
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(first, kind="stable")
    if not np.array_equal(red.codes, ex.codes[first[order]]):
        fail("phase 27: a reduced row's outcome differs from the exhaustive "
             "row it represents")
    image = prog.region.init(torch.device("cpu"))
    sched, split = ex.schedule, 0
    for c in np.unique(inv):
        rows = np.flatnonzero(inv == c)
        if len(set(ex.codes[rows].tolist())) == 1:
            continue
        leaf = prog.leaf_order[int(sched.leaf_id[rows[0]])]
        sig = part.signatures[leaf]
        arr = image.get(leaf)
        if (sig.written or sig.mode_name not in ("free", "lt") or arr is None
                or arr.dtype != torch.float32):
            fail(f"phase 27: class of {leaf} ({sig.mode_name}) mixes "
                 f"outcomes {sorted(set(ex.codes[rows].tolist()))}")
        words = arr.reshape(-1)[torch.as_tensor(sched.word[rows],
                                                dtype=torch.int64)]
        bits = np.asarray(sched.bit[rows])
        hidden = (words.numpy() == 0) & ((bits < 23) | (bits == 31))
        for group in (hidden, ~hidden):
            if len(set(ex.codes[rows[group]].tolist())) > 1:
                fail(f"phase 27: class of {leaf} mixes outcomes beyond the "
                     "flush to zero")
        split += len(rows)
    return split


def equiv_campaigns(work: Path, board: str, card: str, TMR, DWC, REGISTRY,
                    CampaignRunner, hv, hc) -> tuple:
    """Phase 27: equivalence-reduced and delta campaigns on the card (the
    partition is derived on the host from the captured step; every
    campaign runs on the card).  (a) The recorded study's four cells,
    16,384 rows at seed 2026, batch 2048, exhaustive and reduced: the
    reduced weighted counts equal the exhaustive ones and the record's,
    with the record's physical rows and section modes.  (b) The flagship,
    matrixMultiply1024 TMR and DWC, 512 rows at batch 128: reduced equals
    exhaustive.  (c) crc16 TMR fused reduced equals unfused reduced, K2
    launched; matrixMultiply TMR reduced sparse equals reduced dense:
    counts, interesting rows and log weights.  (d) Delta: a crc16 TMR
    equivalence journal of 4096 rows; a rebuilt program re-injects no
    row, codes equal; the matrixMultiply program whose check xors golden
    with 0 re-injects golden's rows only; card fingerprints equal the
    CPU's.  (e) The CLI: ``--equiv -t 16384`` on the card and on the host
    print equal summaries, ``--delta-from`` its journal re-injects no row,
    ``--static-budget`` without ``--stop-when`` is refused as the
    reference refuses it (phase 28 runs it).  (f) A two-shard mesh on
    cuda:0 with equiv equals the single device.  Returns the (K1, K2)
    launches."""
    import dataclasses

    import torch

    from coast_tpu_torch.analysis.equiv import section_fingerprints
    from coast_tpu_torch.inject import logs
    from coast_tpu_torch.parallel.mesh import Mesh
    device = "cuda" if board == "gpu" else "cpu"
    t_phase = time.perf_counter()
    launches = [0, 0]
    argv = ["-f", "matrixMultiply", "-O", "-TMR", "--equiv", "-t", "16384",
            "--seed", "2026", "--batch-size", "2048", "-q"]
    cli_j = str(work / "cli_equiv.journal")
    procs = {"card": start_cli([*argv, "--journal", cli_j], board),
             "host": start_cli(argv, "cpu")}

    def count(label: str) -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    with open(ROOT / "artifacts" / "equiv_study.json") as fh:
        study = json.load(fh)
    strats = {"TMR": TMR, "DWC": DWC}

    # (a) The recorded study.
    hv.LAUNCHES = hc.LAUNCHES = 0
    reduced = {}
    for name, strat in EQUIV_CELLS:
        cell = study["targets"][name][strat]
        prog = strats[strat](REGISTRY[name]())
        t0 = time.perf_counter()
        runner = CampaignRunner(prog, strategy_name=strat, equiv=True)
        t_an = time.perf_counter() - t0
        red = runner.run(study["n"], seed=study["seed"], batch_size=2048)
        ex = CampaignRunner(prog, strategy_name=strat).run(
            study["n"], seed=study["seed"], batch_size=2048)
        modes = {k: s.mode_name
                 for k, s in runner.equiv_partition.signatures.items()}
        if not (red.counts == ex.counts
                and nonzero(ex.counts) == cell["counts"]):
            fail(f"phase 27a {name} {strat}: reduced {red.counts}, "
                 f"exhaustive {ex.counts}, recorded {cell['counts']}")
        if red.physical_n != cell["physical_injections"] \
                or modes != cell["section_modes"]:
            fail(f"phase 27a {name} {strat}: {red.physical_n} physical rows"
                 f" and modes {modes}, recorded "
                 f"{cell['physical_injections']} and "
                 f"{cell['section_modes']}")
        k1, _ = count(f"27a {name} {strat}")
        log(f"  27a {name} {strat}: {nonzero(red.counts)}, "
            f"{red.physical_n} of {red.n} rows ran "
            f"({red.n / red.physical_n:.2f}x); analysis {t_an:.3f} s "
            f"(host), exhaustive {ex.seconds:.3f} s, reduced "
            f"{red.seconds:.3f} s; K1 launches {k1} [{card}]")
        reduced[(name, strat)] = (runner, red)

    # (b) The flagship at full width.
    for strat in ("TMR", "DWC"):
        prog = strats[strat](REGISTRY["matrixMultiply1024"]())
        t0 = time.perf_counter()
        runner = CampaignRunner(prog, strategy_name=strat, equiv=True)
        t_an = time.perf_counter() - t0
        red = runner.run(512, seed=3, batch_size=128)
        ex = CampaignRunner(prog, strategy_name=strat).run(
            512, seed=3, batch_size=128)
        # Every class is one outcome but where a zero float word meets the
        # compare's flush to zero (a limit of the partition's merge
        # argument that the reference's partition shares): those are
        # counted and shown.
        split = ftz_split_classes(runner, ex, red)
        if red.counts != ex.counts and not split:
            fail(f"phase 27b matrixMultiply1024 {strat}: reduced "
                 f"{red.counts} != exhaustive {ex.counts}")
        k1, _ = count(f"27b {strat}")
        if k1 <= 0 and board == "gpu":
            fail(f"phase 27b matrixMultiply1024 {strat}: no K1 launch")
        modes = {k: s.mode_name
                 for k, s in runner.equiv_partition.signatures.items()}
        log(f"  27b matrixMultiply1024 {strat}: modes {modes}, "
            f"{red.physical_n} of 512 rows ran; reduced "
            f"{nonzero(red.counts)}, exhaustive {nonzero(ex.counts)}, "
            f"{split} rows in classes split by the flush to zero; "
            f"analysis {t_an:.3f} s (host), exhaustive {ex.seconds:.3f} s, "
            f"reduced {red.seconds:.3f} s; K1 launches {k1} [{card}]")

    # (c) Fused and sparse.
    plain = reduced[("crc16", "TMR")][1]
    fused_runner = CampaignRunner(TMR(REGISTRY["crc16"](), fuse_step=True),
                                  strategy_name="TMR", equiv=True)
    fused = fused_runner.run(study["n"], seed=study["seed"], batch_size=2048)
    if fused.counts != plain.counts \
            or not np.array_equal(fused.codes, plain.codes):
        fail(f"phase 27c crc16 TMR fused reduced {fused.counts} differs from"
             f" unfused {plain.counts}")
    k1, k2 = count("27c fused")
    if k2 <= 0 and board == "gpu":
        fail("phase 27c: the fused reduced campaign launched K2 no time")
    mm_runner, mm_dense = reduced[("matrixMultiply", "TMR")]
    sparse_runner = CampaignRunner(mm_runner.prog, strategy_name="TMR",
                                   equiv=mm_runner.equiv_partition,
                                   collect="sparse")
    sparse = sparse_runner.run(study["n"], seed=study["seed"],
                               batch_size=2048)
    rows = np.flatnonzero(mm_dense.codes > 1)
    if sparse.counts != mm_dense.counts \
            or not np.array_equal(sparse.interesting_rows, rows) \
            or not np.array_equal(sparse.codes, mm_dense.codes[rows]):
        fail("phase 27c: matrixMultiply TMR reduced sparse differs from "
             "reduced dense")
    path = work / "equiv_sparse.ndjson"
    logs.write_ndjson(sparse, sparse_runner.mmap, str(path))
    with open(path) as fh:
        weights = [json.loads(ln)["weight"]
                   for ln in fh.read().splitlines()[1:]]
    if weights != mm_dense.schedule.class_weight[rows].tolist():
        fail("phase 27c: the sparse log's weights differ from the dense "
             "schedule's")
    path.unlink()
    k1s, _ = count("27c sparse")
    log(f"  27c crc16 TMR fused reduced = unfused ({fused.physical_n} rows, "
        f"K1 {k1}, K2 {k2} launches); matrixMultiply TMR reduced sparse = "
        f"dense ({len(rows)} interesting rows, K1 {k1s} launches) [{card}]")

    # (d) Delta campaigns.
    crc_runner = reduced[("crc16", "TMR")][0]
    jpath = str(work / "crc16_equiv.journal")
    base = crc_runner.run(4096, seed=5, batch_size=1024, journal=jpath)
    rebuilt = CampaignRunner(TMR(REGISTRY["crc16"]()), strategy_name="TMR",
                             equiv=True)
    noop = rebuilt.run_delta(4096, jpath, seed=5, batch_size=1024)
    if noop.delta["reinjected_rows"] != 0 \
            or not np.array_equal(noop.codes, base.codes):
        fail(f"phase 27d: a rebuilt crc16 re-injected "
             f"{noop.delta['reinjected_rows']} rows")
    mm_path = str(work / "mm_equiv.journal")
    mm_base = mm_runner.run(4096, seed=5, batch_size=1024, journal=mm_path)
    region = REGISTRY["matrixMultiply"]()
    old_check = region.check

    def new_check(state):
        state = dict(state)
        state["golden"] = state["golden"] ^ 0
        return old_check(state)

    edited = CampaignRunner(TMR(dataclasses.replace(region, check=new_check)),
                            strategy_name="TMR", equiv=True)
    delta = edited.run_delta(4096, mm_path, seed=5, batch_size=1024)
    golden = edited.equiv_partition.signatures["golden"].leaf_id
    want_rows = int((np.asarray(delta.schedule.leaf_id) == golden).sum())
    if delta.delta["changed_sections"] != ["golden"] \
            or delta.delta["reinjected_rows"] != want_rows \
            or delta.counts != mm_base.counts:
        fail(f"phase 27d: the edited check's delta {delta.delta} "
             f"{delta.counts}, base {mm_base.counts}")
    for name in ("crc16", "matrixMultiply"):
        card_fp = section_fingerprints(TMR(REGISTRY[name]()))
        host_fp = section_fingerprints(TMR(REGISTRY[name](), device="cpu"))
        if card_fp != host_fp:
            fail(f"phase 27d: {name}'s card fingerprints differ from the "
                 "host's")
    k1, _ = count("27d")
    log(f"  27d delta: rebuilt crc16 re-injects 0 of {base.physical_n} rows;"
        f" matrixMultiply with golden ^ 0 re-injects {want_rows} (golden's) "
        f"in {delta.seconds:.3f} s; card fingerprints = host's; K1 "
        f"launches {k1} [{card}]")

    # (e) The CLI (its two --equiv processes started at the phase's start,
    # the two that read the card's journal started together).
    on_card = finish_cli(procs["card"], "phase 27e card")
    on_host = finish_cli(procs["host"], "phase 27e host")
    if steady(on_card["summary"]) != steady(on_host["summary"]):
        fail(f"phase 27e: --equiv on the card {steady(on_card['summary'])} "
             f"differs from the host's {steady(on_host['summary'])}")
    delta_proc = start_cli(["-f", "matrixMultiply", "-O", "-TMR", "-t",
                            "16384", "--seed", "2026", "--batch-size", "2048",
                            "-q", "--delta-from", cli_j], board)
    budget = finish_cli(start_cli(["-f", "matrixMultiply", "-t", "8",
                                   "--delta-from", cli_j, "--static-budget"],
                                  board), "phase 27e static budget",
                        expect_ok=False)
    cli_delta = finish_cli(delta_proc, "phase 27e delta")
    if cli_delta["summary"]["delta"]["reinjected_rows"] != 0:
        fail(f"phase 27e: --delta-from re-injected "
             f"{cli_delta['summary']['delta']['reinjected_rows']} rows")
    if budget["rc"] != 255 or "needs --delta-from AND --stop-when" \
            not in budget["err"]:
        fail(f"phase 27e: --static-budget without --stop-when exited "
             f"{budget['rc']}: {budget['err'].strip()[-300:]}")
    for run in (on_card, cli_delta):
        launches[0] += run["k1"]
        launches[1] += run["k2"]
    log(f"  27e CLI --equiv card = host "
        f"({on_card['summary']['physical_injections']} physical rows), "
        f"--delta-from re-injects 0, --static-budget without --stop-when "
        f"is refused; K1 launches "
        f"{on_card['k1']} + {cli_delta['k1']} [{card}]")

    # (f) The mesh.
    two = Mesh([torch.device(device, 0), torch.device(device, 0)]
               if device == "cuda" else [torch.device("cpu")] * 2)
    single_runner, single = reduced[("matrixMultiply", "DWC")]
    meshed = CampaignRunner(single_runner.prog, strategy_name="DWC",
                            equiv=single_runner.equiv_partition, mesh=two
                            ).run(study["n"], seed=study["seed"],
                                  batch_size=2048)
    if meshed.counts != single.counts or meshed.physical_n != \
            single.physical_n or not np.array_equal(meshed.codes,
                                                    single.codes):
        fail("phase 27f: the two-shard mesh with equiv differs from the "
             "single device")
    k1, _ = count("27f")
    log(f"  27f two-shard mesh on cuda:0 = single device "
        f"({meshed.physical_n} rows, K1 launches {k1}) [{card}]")
    log(f"phase 27: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    return tuple(launches)


# -- phase 28: the static vulnerability map, the isolation prover, the
# static budget and the advisor ------------------------------------------------

# Runs ``python -m <module>`` as the supervisor wrapper does, reporting the
# process's K1 and K2 launches at exit.
def start_module(module: str, argv, env=None) -> subprocess.Popen:
    return spawn(
        [sys.executable, "-c",
         SUPERVISOR.replace("coast_tpu_torch.inject.supervisor", module),
         *argv], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


# Phase 28a's maps: the builds whose verdicts, verdict counts and ACE totals
# are read from the recorded sweep.
PROP_MAPS = (("matrixMultiply", "TMR"), ("matrixMultiply", "DWC"),
             ("crc16", "TMR"), ("matrixMultiply1024", "TMR"),
             ("matrixMultiply1024", "DWC"))


def section_counts(runner, res) -> dict:
    """Per-section outcome counts of a dense campaign."""
    from coast_tpu_torch.inject.classify import CLASS_NAMES
    lids = np.asarray(res.schedule.leaf_id)
    out = {}
    for sec in runner.mmap.sections:
        binc = np.bincount(res.codes[lids == sec.leaf_id],
                           minlength=len(CLASS_NAMES))
        out[sec.name] = {k: int(c) for k, c in zip(CLASS_NAMES, binc) if c}
    return out


def check_edited(region, leaf: str):
    """``region`` whose check sees ``leaf`` xor'ed with 0: only that
    section's check cone (and fingerprint) changes."""
    import dataclasses
    old_check = region.check

    def new_check(state):
        state = dict(state)
        state[leaf] = state[leaf] ^ 0
        return old_check(state)

    return dataclasses.replace(region, check=new_check)


def propagation_phase(work: Path, card: str, TMR, DWC, REGISTRY,
                      CampaignRunner, hv, hc, results) -> tuple:
    """Phase 28: item 17c on the card (the analyses capture on the host;
    every campaign runs on the card).  (a) The vulnerability maps of
    matrixMultiply TMR/DWC, crc16 TMR and matrixMultiply1024 TMR/DWC built
    on the card equal the recorded sweep's; live soundness: no SDC outside
    sdc-possible sections in matrixMultiply TMR (1500 rows at 500) and
    matrixMultiply1024 TMR/DWC (512 at 128, full width).  (b) Clean
    proofs hold with the recorded voted commits; the seeded voter bypass
    is refuted on crc16 unfused and fused and on matrixMultiply1024, and a
    bypassed card build launches no K1 or K2; after it a fresh
    matrixMultiply1024 TMR campaign equals phase 4's, row for row.  (c)
    The static budget on crc16 TMR fused and matrixMultiply TMR: a
    1500-row equivalence journal, then a no-op and a one-section-edit
    delta under ``sdc:0.05;min=128``, plain and static: the same counts,
    the verdicts recorded, no more physical rows.  (d) The advisor on the
    card = on the host for matrixMultiply; matrixMultiply1024 at 512 with
    validation; the static seed.  (e) The stencil's step 3 for both
    placements.  (f) opt ``-propOut``, the lint's ``--propagation``, the
    supervisor's ``--static-budget`` and the advisor's CLI as processes,
    started at the phase's start, each equal to the in-process result.
    Returns the (K1, K2) launches."""
    from coast_tpu_torch.analysis.advisor import advise, harm_rate
    from coast_tpu_torch.inject.classify import CLASS_NAMES
    from coast_tpu_torch.analysis.propagation import (VERDICT_SDC,
                                                      analyze_propagation,
                                                      crossvalidate_counts,
                                                      prove_isolation,
                                                      seeded_voter_bypass)
    from coast_tpu_torch.models import resolve_region
    from coast_tpu_torch.obs.convergence import StopWhen
    t_phase = time.perf_counter()
    launches = [0, 0]
    hv.LAUNCHES = hc.LAUNCHES = 0

    def count() -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    with open(ROOT / "artifacts" / "lint_sweep.json") as fh:
        sweep = json.load(fh)["benchmarks"]
    strats = {"TMR": TMR, "DWC": DWC}

    # (f) The command lines, started now so they overlap the phase.
    prop_out = work / "mm1024_prop.json"
    lint_out = work / "crc16_lint.json"
    sup_j = work / "sup_equiv.journal"
    sup_argv = ["-f", "matrixMultiply", "-O", "-TMR", "-t", "4096", "--seed",
                "9", "--batch-size", "1024", "-q"]
    procs = {
        "opt": start_module("coast_tpu_torch.opt", [
            "-TMR", f"-propOut={prop_out}", "matrixMultiply1024"]),
        "lint": start_module("coast_tpu_torch.analysis.lint", [
            "-TMR", "crc16", "--propagation", "--json", str(lint_out)]),
        "advisor": start_module("coast_tpu_torch.analysis.advisor", [
            "matrixMultiply", "-e", "2048", "-t", "0.02"]),
        "equiv": start_cli([*sup_argv, "--equiv", "--journal", str(sup_j)],
                           "gpu"),
    }

    # (a) The maps, and live soundness.
    maps = {}
    progs = {}
    for name, strat in PROP_MAPS:
        prog = strats[strat](REGISTRY[name]())
        t0 = time.perf_counter()
        vmap = analyze_propagation(prog)
        t_an = time.perf_counter() - t0
        want = sweep[name][strat]["propagation"]
        got = {"verdicts": vmap.section_verdicts(),
               "verdict_counts": vmap.counts(), "ace": vmap.ace_summary()}
        if got != {k: want[k] for k in got}:
            fail(f"phase 28a {name} {strat}: map {got} differs from the "
                 f"recorded {want}")
        maps[(name, strat)] = vmap
        progs[(name, strat)] = prog
        ace = vmap.ace_summary()
        share = ace["sdc_possible_ace_bits"] / max(ace["ace_bits"], 1)
        log(f"  28a {name} {strat}: {vmap.counts()}, sdc-possible ACE "
            f"{ace['sdc_possible_ace_bits']}/{ace['ace_bits']} bits "
            f"({100 * share:.2f}%), analysis {t_an:.3f} s (host capture, "
            f"clean run on the card) [{card}]")
    count()
    for (name, strat), (n, batch) in (
            (("matrixMultiply", "TMR"), (1500, 500)),
            (("matrixMultiply1024", "TMR"), (512, 128)),
            (("matrixMultiply1024", "DWC"), (512, 128))):
        runner = CampaignRunner(progs[(name, strat)], strategy_name=strat)
        res = runner.run(n, seed=13, batch_size=batch)
        violations = crossvalidate_counts(maps[(name, strat)],
                                          section_counts(runner, res))
        if violations:
            fail(f"phase 28a {name} {strat}: soundness violations "
                 f"{violations}")
        k1, _ = count()
        if k1 <= 0:
            fail(f"phase 28a {name} {strat}: the campaign launched K1 no "
                 "time")
        log(f"  28a live soundness {name} {strat}: {nonzero(res.counts)}, "
            f"{n} rows, no SDC outside sdc-possible sections; "
            f"{res.injections_per_sec:.1f} inj/s, K1 launches {k1} [{card}]")

    # (b) Isolation.
    proofs = {}
    for name in ("matrixMultiply", "matrixMultiply1024", "crc16"):
        for strat in ("TMR", "DWC"):
            prog = progs.get((name, strat)) or strats[strat](REGISTRY[name]())
            t0 = time.perf_counter()
            proof = prove_isolation(prog, strategy=strat)
            want = sweep[name][strat]["propagation"]["isolation"]
            if not proof.holds or proof.vacuous \
                    or len(proof.voted_commits) != want["voted_commits"] \
                    or proof.assumptions != want["assumptions"]:
                fail(f"phase 28b {name} {strat}: {proof.summary()} against "
                     f"the recorded {want}")
            proofs[(name, strat)] = proof
            log(f"  28b {name} {strat}: isolation holds, "
                f"{len(proof.voted_commits)} voted commits "
                f"({time.perf_counter() - t0:.3f} s, host)")
    flip = {"leaf_id": 1, "lane": 0, "word": 0, "bit": 5, "t": 0}
    for name, kw in (("crc16", {}), ("crc16", {"fuse_step": True}),
                     ("matrixMultiply1024", {})):
        with seeded_voter_bypass():
            bad = TMR(REGISTRY[name](), **kw)
            proof = prove_isolation(bad, strategy="TMR")
            before = (hv.LAUNCHES, hc.LAUNCHES)
            if name == "crc16":
                rec = bad.run(flip)
                if (hv.LAUNCHES, hc.LAUNCHES) != before \
                        or int(rec["corrected"]) != 0:
                    fail(f"phase 28b {name} {kw}: the bypassed build "
                         "launched a kernel or corrected a flip")
        if proof.holds or not proof.leaks \
                or not all(l.path for l in proof.leaks):
            fail(f"phase 28b {name} {kw}: the seeded bypass was not "
                 f"refuted: {proof.summary()}")
        log(f"  28b bypass {name} {kw or ''}: refuted, "
            f"{proof.total_leak_paths} leak paths, e.g. "
            f"{proof.leaks[0].format()[:160]}")
    count()
    region = REGISTRY["matrixMultiply1024"]()
    again = CampaignRunner(TMR(region), strategy_name="TMR").run(
        1024, seed=1, batch_size=128)
    first = results[TMR]
    for col in ("codes", "errors", "corrected", "steps"):
        if not np.array_equal(getattr(again, col), getattr(first, col)):
            fail(f"phase 28b: after the bypass, matrixMultiply1024 TMR's "
                 f"{col} differ from phase 4's")
    k1, _ = count()
    log(f"  28b after the bypass: matrixMultiply1024 TMR 1024 rows equal "
        f"phase 4's, K1 launches {k1} [{card}]")

    # (c) The static budget.
    stop = StopWhen.parse("sdc:0.05;min=128")
    for name, kw, edit in (("crc16", {"fuse_step": True}, "crc"),
                           ("matrixMultiply", {}, "results")):
        base_runner = CampaignRunner(TMR(REGISTRY[name](), **kw),
                                     strategy_name="TMR", equiv=True)
        jpath = str(work / f"{name}_sb.journal")
        base = base_runner.run(1500, seed=4, batch_size=500, journal=jpath)
        for label, region in (("no-op", REGISTRY[name]()),
                              (f"{edit} edited",
                               check_edited(REGISTRY[name](), edit))):
            runner = CampaignRunner(TMR(region, **kw), strategy_name="TMR",
                                    equiv=True)
            plain = runner.run_delta(1500, jpath, seed=4, batch_size=64,
                                     stop_when=stop)
            static = runner.run_delta(1500, jpath, seed=4, batch_size=64,
                                      stop_when=stop, static_budget=True)
            sb = static.delta["static_budget"]
            want_changed = [] if label == "no-op" else [edit]
            if plain.delta["changed_sections"] != want_changed \
                    or static.physical_n > plain.physical_n \
                    or set(sb["verdicts"]) != set(
                        runner.equiv_partition.signatures):
                fail(f"phase 28c {name} {label}: plain {plain.delta}, "
                     f"static {static.delta} ({plain.physical_n} vs "
                     f"{static.physical_n} rows)")
            if label == "no-op" and static.counts != base.counts:
                fail(f"phase 28c {name}: the no-op static delta's counts "
                     f"{static.counts} differ from the base's {base.counts}")
            k1, k2 = count()
            log(f"  28c {name} {kw or ''} {label}: plain "
                f"{plain.physical_n} rows, static {static.physical_n} "
                f"(order {sb.get('order', [])}, relaxed "
                f"{sb.get('relaxed_min', {})}, verdict of {edit} "
                f"{sb['verdicts'][edit]}); K1 {k1}, K2 {k2} launches "
                f"[{card}]")
            if kw and label != "no-op" and k2 <= 0:
                fail(f"phase 28c {name} fused: the delta launched K2 no "
                     "time")

    # (d) The advisor.
    mm_card = advise(REGISTRY["matrixMultiply"](), budget=2048,
                     target_harm=0.02, batch_size=1024)
    mm_host = advise(REGISTRY["matrixMultiply"](), budget=2048,
                     target_harm=0.02, batch_size=1024, device="cpu")

    def harms(adv):
        return [(h.name, h.injections, h.sdc, h.due, h.invalid, h.words)
                for h in adv.ranked]

    if (mm_card.protect, harms(mm_card), mm_card.config_text) \
            != (mm_host.protect, harms(mm_host), mm_host.config_text):
        fail(f"phase 28d: the advice on the card {mm_card.protect} "
             f"differs from the host's {mm_host.protect}")
    k1, _ = count()
    log(f"  28d advise(matrixMultiply) card = host: protect "
        f"{mm_card.protect}; K1 launches {k1} [{card}]")
    t0 = time.perf_counter()
    big = advise(REGISTRY["matrixMultiply1024"](), budget=512,
                 batch_size=128)
    if big.achieved is None or harm_rate(big.achieved) \
            > harm_rate(big.baseline):
        fail(f"phase 28d: matrixMultiply1024's selective harm "
             f"{big.achieved} exceeds the unprotected {big.baseline}")
    k1, _ = count()
    log(f"  28d advise(matrixMultiply1024, 512): protect {big.protect}, "
        f"harm unprotected {harm_rate(big.baseline):.4f}, selective "
        f"{harm_rate(big.achieved):.4f}, full {harm_rate(big.full):.4f}; "
        f"{time.perf_counter() - t0:.1f} s, K1 launches {k1} [{card}]")
    seeded = advise(REGISTRY["matrixMultiply"](), budget=2048,
                    static_seed=True, validate=False)
    if seeded.static_verdicts.get("golden") != VERDICT_SDC \
            or sorted(seeded.protect) != sorted(mm_card.protect):
        fail(f"phase 28d: the static seed gave {seeded.protect}, "
             f"verdicts {seeded.static_verdicts}")
    count()
    log(f"  28d static seed on matrixMultiply: protect {seeded.protect}")

    # (e) The stencil's step 3.
    for placement in ("compute", "link"):
        prog = TMR(resolve_region("stencil", placement=placement))
        vmap = analyze_propagation(prog)
        reach = {g: vmap.shard_reach[g].get("cross_shard")
                 for g in ("grid0", "grid1")}
        if any(v is not (placement == "link") for v in reach.values()):
            fail(f"phase 28e {placement}: grid reach {reach}")
        runner = CampaignRunner(prog, strategy_name="TMR")
        res = runner.run(480, seed=7, batch_size=48)
        violations = crossvalidate_counts(vmap, section_counts(runner, res))
        if violations:
            fail(f"phase 28e {placement}: soundness violations "
                 f"{violations}")
        k1, _ = count()
        log(f"  28e stencil {placement}: cross_shard {reach}, "
            f"{nonzero(res.counts)}, no SDC outside sdc-possible sections; "
            f"K1 launches {k1} [{card}]")

    # (f) The command lines.
    def done(key, what):
        got = finish_cli(procs[key], what)
        launches[0] += got["k1"]
        launches[1] += got["k2"]
        return got

    done("opt", "phase 28f opt -propOut")
    proof = prove_isolation(progs[("matrixMultiply1024", "TMR")],
                            strategy="TMR")
    want = json.loads(json.dumps(
        {"vulnerability_map": maps[("matrixMultiply1024", "TMR")].summary(),
         "isolation": proof.summary()}, sort_keys=True))
    if json.loads(prop_out.read_text()) != want:
        fail("phase 28f: opt -propOut's document differs from the "
             "in-process map and proof")
    lint_run = done("lint", "phase 28f lint --propagation")
    lint_doc = json.loads(lint_out.read_text())
    if lint_doc["propagation"]["crc16:TMR"] != json.loads(json.dumps(
            maps[("crc16", "TMR")].summary())) \
            or "static vulnerability map: crc16" not in lint_run["out"]:
        fail("phase 28f: the lint's --propagation map differs from the "
             "in-process one")
    equiv_cli = done("equiv", "phase 28f supervisor --equiv")
    delta_cli = finish_cli(start_cli(
        [*sup_argv, "--delta-from", str(sup_j), "--stop-when",
         "sdc:0.05;min=128", "--static-budget"], "gpu"),
        "phase 28f supervisor --static-budget")
    launches[0] += delta_cli["k1"]
    launches[1] += delta_cli["k2"]
    got, base = delta_cli["summary"], equiv_cli["summary"]
    want = {"verdicts": maps[("matrixMultiply", "TMR")].section_verdicts()}
    if got["delta"]["static_budget"] != want \
            or got["delta"]["changed_sections"] != [] \
            or {k: got.get(k) for k in CLASS_NAMES} \
            != {k: base.get(k) for k in CLASS_NAMES}:
        fail(f"phase 28f: --static-budget gave {got}, the --equiv run "
             f"{base}, the in-process verdicts {want}")
    adv_run = done("advisor", "phase 28f advisor")
    if mm_card.format() not in adv_run["out"]:
        fail("phase 28f: the advisor CLI's report differs from the "
             f"in-process advice:\n{adv_run['out'][-2000:]}")
    count()
    log("  28f opt -propOut, lint --propagation, supervisor --equiv then "
        "--static-budget, advisor CLI: each exits 0 and equals the "
        f"in-process result [{card}]")
    log(f"phase 28: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0 or launches[1] <= 0:
        fail(f"phase 28 launched K1 {launches[0]} and K2 {launches[1]} "
             "times")
    return tuple(launches)


# -- phase 29: the region lifters, the fuzz tier, the flag-matrix harness
# and the smoke drivers on the card (item 17d, first part).

LIFTED_MM_ANNOS = ("first", "second")     # the corpus matrix's mm256 entry


def relift(hand, annotated, hand_check: bool = True):
    """``lift_step`` of a registry region from its program alone, with the
    corpus matrix's annotations (``tests/test_torch_lifter_corpus_a.py``).
    ``hand_check=False`` leaves ``check``/``output``/``max_steps`` to the
    lifter: written memory as the output, the golden made per device."""
    from coast_tpu_torch.frontend import lift_step
    meta = ({"store_slice": hand.meta["store_slice"]}
            if "store_slice" in hand.meta else None)
    own = ({"check": hand.check, "output": hand.output,
            "max_steps": hand.max_steps} if hand_check else {})
    lifted = lift_step(
        hand.name + "_lifted", hand.step, hand.init, done=hand.done,
        annotations={leaf: hand.spec[leaf] for leaf in annotated},
        default_xmr=hand.default_xmr, functions=hand.functions, meta=meta,
        **own)
    lifted.spec = {k: lifted.spec[k] for k in hand.spec}
    return lifted


def fault_free_errors(torch, region, rows: int) -> np.ndarray:
    """``region.check`` of ``rows`` fault-free unprotected rows run to
    their end on the card."""
    from coast_tpu_torch.ir.region import rows as row_mask
    dev = torch.device("cuda")
    state = {k: v.unsqueeze(0).expand(rows, *v.shape).clone()
             for k, v in region.init(dev).items()}
    halted = torch.zeros(rows, dtype=torch.bool, device=dev)
    step = region.bound_step()
    with torch.no_grad():
        for t in range(region.max_steps):
            new = {**state, **step(state, t)}
            state = {k: torch.where(row_mask(halted, v), state[k], v)
                     for k, v in new.items()}
            halted = halted | region.done(state)
            if bool(halted.all()):
                break
        return region.check(state).cpu().numpy()


def same_records(what: str, got, want, cols=("codes", "errors", "corrected",
                                              "steps")) -> None:
    for col in cols:
        if not np.array_equal(getattr(got, col), getattr(want, col)):
            fail(f"{what}: {col} differ")
    if got.counts != want.counts:
        fail(f"{what}: counts {got.counts} != {want.counts}")


def lifted_functions(torch):
    """29c's two functions, written with ``frontend.loops``: a single scan
    over a 1 MiB carry (262,144 words, 64 iterations), and a while loop
    (gcd) then a scan."""
    from coast_tpu_torch.frontend import loops
    from coast_tpu_torch.ops.u32 import lsr

    def big_scan(c0, xs):
        def body(c, x):
            c = (c ^ x) * 16777619 + lsr(c, 13)
            return c, c[:8]
        final, ys = loops.scan(body, c0, xs)
        return final ^ -1515870811, ys

    def urem(x, y):
        xs = x.to(torch.int64) & 0xFFFFFFFF
        ys = y.to(torch.int64) & 0xFFFFFFFF
        r = torch.remainder(xs, torch.where(ys == 0, 1, ys))
        return torch.where(ys == 0, xs, r).to(torch.int32)

    def gcd_scan(a, b, data):
        def cond(c):
            return c[1] != 0

        def body(c):
            x, y = c
            return (y, urem(x, y))
        g, _ = loops.while_loop(cond, body, (a, b))

        def sbody(acc, x):
            return acc + x * g, acc
        tot, trace = loops.scan(
            sbody, torch.zeros((), dtype=torch.int32, device=data.device),
            data)
        return tot, trace

    rng = np.random.RandomState(29)
    words = rng.randint(0, 2**32, 262144, np.uint32).view(np.int32)
    xs = rng.randint(0, 2**32, 64, np.uint32).view(np.int32)
    data = (np.arange(12, dtype=np.uint32) * np.uint32(2654435761)
            & np.uint32(0x3FF)).view(np.int32)
    return [("big_scan", big_scan, (torch.from_numpy(words.copy()),
                                    torch.from_numpy(xs.copy()))),
            ("gcd_scan", gcd_scan, (torch.tensor(462, dtype=torch.int32),
                                    torch.tensor(1071, dtype=torch.int32),
                                    torch.from_numpy(data.copy())))]


def lifted_phase(card: str, TMR, DWC, REGISTRY, CampaignRunner, hv,
                 hc) -> tuple:
    """Phase 29: item 17d's first part on the card.  (a) ``lift_step``
    re-derives matrixMultiply1024 from its program with the annotations
    ``first``/``second``: the hand spec's kinds and nominal steps, and TMR
    and DWC campaigns (512 rows at 128, seed 1, full width) equal to the
    hand region's, through K1.  (a') Lifted again with the lifter's own
    check and output, the golden made by a fault-free run on the card: 128
    fault-free rows read 0 errors, and a TMR campaign (512 at 128) has the
    hand region's codes on every row neither injected into ``golden`` nor
    ``mm256.order_sensitive``, and success on the ``golden`` rows.  (b) The lifted crc16 under
    ``TMR(..., fuse_step=True)``, 4096 rows: the fused hand region's
    records, through K2.  (c) ``lift_fn`` of a single scan over a 1 MiB
    carry and of a while-then-scan function: output = the function's eager
    result on the card; a 4096-row TMR campaign whose first 64 rows equal
    a CPU rerun.  (d) ``fuzz.main(["-n", "20", "-d", "cuda"])``.  (e) The
    harness: fast.yml's benchmark matrix, full.yml's 18 OPT_PASSES on
    matrixMultiply and crc16, and the eight ported drivers, on the card.
    Returns the (K1, K2) launches."""
    import contextlib
    import io

    import torch

    from coast_tpu_torch.frontend import lift_fn
    from coast_tpu_torch.models import mm256
    from coast_tpu_torch.testing import fuzz, harness
    t_phase = time.perf_counter()
    launches = [0, 0]
    hv.LAUNCHES = hc.LAUNCHES = 0

    def count() -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    # (a) The flagship, re-lifted.
    t0 = time.perf_counter()
    hand = REGISTRY["matrixMultiply1024"]()
    lifted = relift(hand, LIFTED_MM_ANNOS)
    kinds = {k: v.kind for k, v in lifted.spec.items()}
    if kinds != {k: v.kind for k, v in hand.spec.items()} \
            or not lifted.nominal_steps == hand.nominal_steps == 16:
        fail(f"phase 29a: matrixMultiply1024 lifted as {kinds}, "
             f"{lifted.nominal_steps} steps")
    lift_s = time.perf_counter() - t0
    hand_tmr = None
    for strat in (TMR, DWC):
        want = CampaignRunner(strat(hand)).run(512, seed=1, batch_size=128)
        count()
        got = CampaignRunner(strat(lifted)).run(512, seed=1, batch_size=128)
        k1, _ = count()
        same_records(f"phase 29a matrixMultiply1024 {strat.__name__}", got,
                     want)
        if k1 <= 0:
            fail(f"phase 29a: the lifted {strat.__name__} campaign launched "
                 "K1 no time")
        hand_tmr = want if strat is TMR else hand_tmr
        log(f"  29a lifted matrixMultiply1024 {strat.__name__}: records = "
            f"the hand region's, {got.counts}, {got.injections_per_sec:.1f} "
            f"inj/s, K1 {k1} [{card}]")
    log(f"  29a lift_step of matrixMultiply1024: {lift_s:.1f} s, "
        f"{lifted.nominal_steps} steps = the hand spec's (capture on the "
        "host, nominal steps on the card)")

    # (a') The lifter's own check and output on a float program: the
    # golden made by a one-row fault-free run on the card, compared at the
    # campaign's batch (cuBLAS picks its kernel by shape).
    lifted = relift(hand, LIFTED_MM_ANNOS, hand_check=False)
    lifted.spec = {k: lifted.spec[k] for k in hand.spec}
    clean = fault_free_errors(torch, lifted, 128)
    if clean.any():
        fail(f"phase 29a': {int((clean != 0).sum())} of 128 fault-free rows "
             "of the lifted matrixMultiply1024 differ from its golden")
    prog = TMR(lifted)
    got = CampaignRunner(prog).run(512, seed=1, batch_size=128)
    k1, _ = count()
    sched = got.schedule
    on_golden = np.array([prog.leaf_order[i] == "golden"
                          for i in np.asarray(sched.leaf_id)])
    # The lifter's check compares the written memory (first, results,
    # second) word for word, not results against the hand golden leaf: a
    # flip into `golden` is the hand check's SDC and nothing here, and a
    # mantissa flip of first/second/acc (mm256.order_sensitive) may leave
    # a subnormal the voters read as zero in the image while the product
    # stays exact.
    same = ~on_golden & ~mm256.order_sensitive(prog.leaf_order,
                                               sched.leaf_id, sched.bit)
    if not np.array_equal(got.codes[same], hand_tmr.codes[same]) \
            or got.codes[on_golden].any():
        fail("phase 29a': the lifted matrixMultiply1024 with its own check "
             f"classifies unlike the hand region ({got.counts} against "
             f"{hand_tmr.counts})")
    log(f"  29a' lifted matrixMultiply1024, the lifter's check: 128 "
        f"fault-free rows read 0 errors; TMR 512 at 128: {got.counts} "
        f"(hand {hand_tmr.counts}); codes = the hand region's on the "
        f"{int(same.sum())} rows neither `golden` nor order-sensitive, "
        f"success on the {int(on_golden.sum())} `golden` rows, K1 {k1} "
        f"[{card}]")

    # (b) crc16, fused.
    hand = REGISTRY["crc16"]()
    lifted = relift(hand, ("msg",))
    want = CampaignRunner(TMR(hand, fuse_step=True)).run(
        4096, seed=1, batch_size=4096)
    count()
    prog = TMR(lifted, fuse_step=True)
    if prog._fuse_plan is None:
        fail("phase 29b: the lifted crc16 built no fused plan")
    got = CampaignRunner(prog).run(4096, seed=1, batch_size=4096)
    _, k2 = count()
    same_records("phase 29b lifted crc16 TMR fused", got, want)
    if k2 <= 0:
        fail("phase 29b: the lifted fused campaign launched K2 no time")
    log(f"  29b lifted crc16 TMR fused: records = the fused hand region's, "
        f"{got.counts}, K2 {k2} [{card}]")

    # (c) lift_fn.
    for name, fn, args in lifted_functions(torch):
        t0 = time.perf_counter()
        region = lift_fn(name, fn, *args)
        lift_s = time.perf_counter() - t0
        with torch.no_grad():
            eager = fn(*[a.cuda() for a in args])
        want = torch.cat([o.reshape(-1) for o in eager]).cpu()
        final = region.run_unprotected("cuda")
        out = region.output({k: v.unsqueeze(0)
                             for k, v in final.items()})[0].cpu()
        if not torch.equal(out, want):
            fail(f"phase 29c {name}: lifted output differs from the eager "
                 "result on the card")
        batch = 512 if name == "big_scan" else 4096
        runner = CampaignRunner(TMR(region))
        res = runner.run(4096, seed=1, batch_size=batch)
        k1, _ = count()
        if k1 <= 0:
            fail(f"phase 29c {name}: the campaign launched K1 no time")
        sub = res.schedule.slice(0, 64)
        cpu = CampaignRunner(TMR(region, device="cpu")).run_schedule(
            sub, batch_size=64)
        for col in ("codes", "errors", "corrected", "steps"):
            if not np.array_equal(getattr(res, col)[:64], getattr(cpu, col)):
                fail(f"phase 29c {name}: {col} of the first 64 rows differ "
                     "between the card and the CPU")
        log(f"  29c lift_fn {name}: {sorted(region.spec)}, "
            f"{region.nominal_steps} steps, lifted in {lift_s:.1f} s; "
            f"output = eager; TMR 4096 at {batch}: {res.counts}, "
            f"{res.injections_per_sec:.1f} inj/s, K1 {k1}; 64 rows = CPU "
            f"[{card}]")

    # (d) The fuzz tier.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fuzz.main(["-n", "20", "-d", "cuda"])
    if rc != 0 or buf.getvalue().splitlines()[-1:] != ["Success!"]:
        fail(f"phase 29d: fuzz -n 20 -d cuda failed:\n{buf.getvalue()}")
    k1, k2 = count()
    log(f"  29d fuzz -n 20 -d cuda: Success! in "
        f"{time.perf_counter() - t0:.1f} s, K1 {k1} [{card}]")

    # (e) The harness: the matrices and the drivers.
    t0 = time.perf_counter()
    fast = {k: harness.FAST[k] for k in ("benchmarks", "OPT_PASSES")}
    full = {"benchmarks": [e for e in harness.FULL["benchmarks"]
                           if e["path"] in ("matrixMultiply", "crc16")],
            "OPT_PASSES": harness.FULL["OPT_PASSES"]}
    # The drivers of the slices up to 29 (phases 30c, 31d, 32b, 33b and
    # 34c run the later ones).
    drivers = {"drivers": [d for d in harness.FAST["drivers"]
                           if d["module"] in harness.PORTED_DRIVERS
                           and d["module"] not in LATER_PHASE_DRIVERS]}
    if len(drivers["drivers"]) != 8:
        fail(f"phase 29e: {len(drivers['drivers'])} ported drivers")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            cells = harness.run_config(fast, quiet=True, device="cuda")
            cells_full = harness.run_config(full, quiet=True, device="cuda")
            t_cells = time.perf_counter() - t0
            ran = harness.run_drivers(drivers, quiet=True, device="cuda")
        except harness.HarnessError as e:
            fail(f"phase 29e: {e}\n{buf.getvalue()[-3000:]}")
    if (cells, cells_full, ran) != (12, 36, 8):
        fail(f"phase 29e: {cells} + {cells_full} cells, {ran} drivers")
    k1, k2 = count()
    log(f"  29e harness: fast.yml 4 x 3 and full.yml 18 x 2 cells exit 0 "
        f"with 'E: 0' in {t_cells:.1f} s; the 8 drivers print Success! in "
        f"{time.perf_counter() - t0 - t_cells:.1f} s; K1 {k1}, K2 {k2} "
        f"[{card}]")
    log(f"phase 29: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0 or launches[1] <= 0:
        fail(f"phase 29 launched K1 {launches[0]} and K2 {launches[1]} "
             "times")
    return tuple(launches)


# The smoke drivers phases 30c, 31d, 32b, 33b and 34c run (phase 29e runs
# the others).
LATER_PHASE_DRIVERS = ("fused_smoke", "obs_live_smoke", "slo_smoke",
                       "fleet_smoke", "profile_smoke", "ci_smoke",
                       "serve_smoke")


def http_get(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode("utf-8")


def observability_phase(work: Path, card: str, torch, TMR, REGISTRY,
                        CampaignRunner, hv, hc) -> tuple:
    """Phase 30: the port's obs layer on the card (see the module
    docstring; 30b runs in phase 16).  Returns the (K1, K2) launches."""
    import contextlib
    import io
    from coast_tpu_torch import obs
    from coast_tpu_torch.breakdown import kernel_times
    from coast_tpu_torch.testing import fused_smoke, obs_live_smoke
    t_phase = time.perf_counter()
    launches = [0, 0]

    def count() -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    hv.LAUNCHES = hc.LAUNCHES = 0
    # (a) A profiled flagship campaign with every surface on, under
    # torch.profiler (device activity only, as breakdown.py takes it).
    name, limit = card.rsplit(", ", 1)
    prog = TMR(REGISTRY["matrixMultiply1024"]())
    n, batch, seed = 512, 128, 30
    off = CampaignRunner(prog, strategy_name="TMR").run(n, seed=seed,
                                                        batch_size=batch)
    tel = obs.Telemetry()
    status = work / "phase30_status.json"
    trace = work / "phase30_trace.json"
    hub = obs.CampaignMetrics(status_path=str(status))
    server = obs.MetricsServer(hub, port=0)
    port = server.start()
    runner = CampaignRunner(prog, strategy_name="TMR", telemetry=tel,
                            metrics=hub, profile=True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as tp:
            res = runner.run(n, seed=seed, batch_size=batch)
            torch.cuda.synchronize()
        prom = http_get(f"http://127.0.0.1:{port}/metrics")
        doc = json.loads(http_get(f"http://127.0.0.1:{port}/status"))
    finally:
        server.stop()
    obs.write_trace(tel, str(trace), metadata={"phase": 30})
    summ = res.summary()
    prof, mfu = summ["profile"], summ.get("mfu") or {}
    # The identity, before the block's rounding to 6 digits: the host's
    # other time is what the busy and gap seconds leave of the wall, and
    # no bucket is negative.
    p = runner.profiler
    other = res.seconds - p._busy_s - p._gap_s
    if (other < 0 or p._gap_s < 0 or p._busy_s <= 0
            or (prof["wall_s"], prof["device_busy_s"], prof["host_gap_s"],
                prof["host_other_s"]) != (
                round(res.seconds, 6), round(p._busy_s, 6),
                round(p._gap_s, 6), round(other, 6))):
        fail(f"phase 30a: the attribution does not sum to the wall: {prof}")
    for col in ("codes", "errors", "corrected", "steps"):
        if not np.array_equal(getattr(res, col), getattr(off, col)):
            fail(f"phase 30a: {col} differ with the profiler on")
    if res.counts != off.counts:
        fail(f"phase 30a: counts {res.counts} with the profiler on, "
             f"{off.counts} off")
    labels = 'benchmark="matrixMultiply1024",strategy="TMR"'
    file_doc = json.loads(status.read_text())
    if (f"coast_campaign_rows_done{{{labels}}} {n}" not in prom
            or f'coast_campaign_state{{{labels},state="finished"}} 1'
            not in prom or doc["state"] != "finished"
            or doc["done_rows"] != n or file_doc["done_rows"] != n
            or file_doc["state"] != "finished"
            or doc["counts"].get("sdc", 0) != res.counts["sdc"]):
        fail(f"phase 30a: /metrics, /status or the status file do not "
             f"report the {n} finished rows: {doc.get('state')} "
             f"{doc.get('done_rows')}, file {file_doc.get('done_rows')}")
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X" and e["tid"] == 2]
    if len(device) != prof["dispatches"] or any(
            e["name"] != "device:step" for e in device):
        fail(f"phase 30a: {len(device)} device-track spans for "
             f"{prof['dispatches']} dispatches")
    kernel_s = sum(k["us"] for k in kernel_times(tp)) / 1e6
    if (mfu.get("backend") != "gpu" or name not in str(
            mfu.get("peak_source")) or not mfu.get("achieved_mfu")):
        fail(f"phase 30a: the mfu block does not name the card: {mfu}")
    if not kernel_s > 0 or prof["device_busy_s"] < kernel_s:
        fail(f"phase 30a: device_busy_s {prof['device_busy_s']} below the "
             f"campaign's summed kernel time {kernel_s:.6f} s")
    k1, k2 = count()
    log(f"phase 30a: matrixMultiply1024 TMR {n} at {batch}, profiled: "
        f"wall {prof['wall_s']} s = device busy {prof['device_busy_s']} + "
        f"host gap {prof['host_gap_s']} + host other "
        f"{prof['host_other_s']} ({prof['dispatches']} dispatches); summed "
        f"kernel time under torch.profiler {kernel_s:.6f} s <= device busy; "
        f"records = the unprofiled run's; /metrics, /status and the status "
        f"file at {n} finished rows; {len(device)} device-track spans; mfu: "
        f"useful {mfu['useful_ops_per_run']} / program "
        f"{mfu['program_ops_per_run']} ops a run (overhead "
        f"{mfu['flops_overhead']}), achieved {mfu['achieved_ops_per_s']} "
        f"ops/s, MFU {mfu['achieved_mfu']}, roofline ceiling "
        f"{mfu['roofline_mfu']}, voter bytes share "
        f"{mfu['voter_bytes_share']}, peak {mfu['peak_source']}; K1 {k1} "
        f"[{card}]")
    log(json.dumps({"phase30_profile": prof, "phase30_mfu": mfu,
                    "phase30_kernel_s": kernel_s}))

    # (c) The two smoke drivers of this slice on the card.
    for drv in (obs_live_smoke, fused_smoke):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = drv.main(["-d", "cuda"])
        out = buf.getvalue().splitlines()
        drv_name = drv.__name__.rsplit(".", 1)[-1]
        if drv is fused_smoke and rc != 0:
            # The op-count oracle: the port's eager engine has no per-step
            # bookkeeping for the fused engine to remove (ROADMAP Queue
            # C).  Its other two oracles must hold.
            errors = [ln for ln in out if ln.startswith("Error")]
            if (rc != 1 or not any(ln.startswith("byte parity:")
                                   for ln in out)
                    or not any(ln.startswith("journal identity:")
                               for ln in out)
                    or any("overhead reduction" not in ln for ln in errors)):
                fail(f"phase 30c: fused_smoke -d cuda:\n{buf.getvalue()}")
            verdict = ("exit 1 on the op-count oracle alone: " + "; ".join(
                ln for ln in out if "flops_overhead" in ln))
        elif rc != 0 or out[-1:] != ["Success!"]:
            fail(f"phase 30c: {drv_name} -d cuda failed:\n{buf.getvalue()}")
        else:
            verdict = "Success!"
        k1, k2 = count()
        log(f"phase 30c: {drv_name} -d cuda: {verdict} in "
            f"{time.perf_counter() - t0:.1f} s, K1 {k1}, K2 {k2} [{card}]")

    # (d) What default telemetry costs on the host-bound main path.
    mm = TMR(REGISTRY["matrixMultiply"]())
    rows, batch = 16384, 4096
    rates = {"default": [], "NULL": []}
    runners = {"default": CampaignRunner(mm, strategy_name="TMR"),
               "NULL": CampaignRunner(mm, strategy_name="TMR",
                                      telemetry=obs.NULL)}
    runners["default"].run(batch, seed=0, batch_size=batch)      # warm-up
    counts = set()
    for which in ("default", "NULL", "default", "NULL", "NULL", "default"):
        got = runners[which].run(rows, seed=1, batch_size=batch)
        rates[which].append(got.injections_per_sec)
        counts.add(json.dumps(got.counts, sort_keys=True))
    if len(counts) != 1:
        fail(f"phase 30d: counts differ with and without telemetry: {counts}")
    k1, k2 = count()
    med = {k: statistics.median(v) for k, v in rates.items()}
    log(f"phase 30d: matrixMultiply TMR {rows} at {batch}: default "
        f"telemetry {rates['default']} inj/s (median {med['default']}), "
        f"obs.NULL {rates['NULL']} inj/s (median {med['NULL']}); cost "
        f"{100 * (1 - med['default'] / med['NULL']):.2f} % of the NULL "
        f"rate; K1 {k1} [{card}]")
    log(json.dumps({"phase30_telemetry_inj_per_s": rates}))
    log(f"phase 30: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0 or launches[1] <= 0:
        fail(f"phase 30 launched K1 {launches[0]} and K2 {launches[1]} "
             "times")
    return tuple(launches)


# The SLO set of phase 31: the two rate objectives must read ok on the
# flagship; the dispatch latency is printed and not compared (the port's
# dispatch histogram is its busy window, an upper bound of the device time).
SLO31 = "sdc_rate<=0.5,availability>=0.5,p99_dispatch<=30;min=64"


# A fleet worker's exit line: its own K1 and K2 launches.
WORKER_LAUNCHES = re.compile(r"kernel launches K1 (\d+), K2 (\d+)")


def worker_launches(text: str) -> tuple:
    """The summed (K1, K2) launches the fleet workers in ``text`` report
    at exit (a worker killed with SIGKILL reports nothing)."""
    got = [tuple(map(int, m)) for m in WORKER_LAUNCHES.findall(text)]
    return sum(k for k, _ in got), sum(k for _, k in got), len(got)


def slo_phase(work: Path, card: str, TMR, REGISTRY, CampaignRunner,
              hv, hc) -> tuple:
    """Phase 31: reliability SLOs and the verb dispatcher on the card (see
    the module docstring).  Returns the (K1, K2) launches."""
    import contextlib
    import io
    from coast_tpu_torch import obs
    from coast_tpu_torch.obs.slo import status_line
    from coast_tpu_torch.testing import slo_smoke
    t_phase = time.perf_counter()
    launches = [0, 0]

    def count() -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    hv.LAUNCHES = hc.LAUNCHES = 0
    # (c) The supervisor's --slo as one process, fused, started first: it
    # runs while the in-process checks below use the card.
    sup_status = work / "phase31_supervisor_status.json"
    sup = start_cli(["-f", "matrixMultiply", "--opt-passes=-TMR -fuseStep",
                     "-t", "8192", "--batch-size", "2048", "-q", "--slo",
                     "sdc_rate<=0.5;min=64", "--status-json",
                     str(sup_status)], "gpu")

    # (a) The flagship with an attached SLO set: the verdicts on every
    # surface.
    prog = TMR(REGISTRY["matrixMultiply1024"]())
    n, batch = 512, 128
    runner = CampaignRunner(prog, strategy_name="TMR", slo=SLO31,
                            profile=True)
    server = obs.MetricsServer(runner.metrics, port=0)
    port = server.start()
    try:
        res = runner.run(n, seed=31, batch_size=batch)
        doc = json.loads(http_get(f"http://127.0.0.1:{port}/status"))
        prom = http_get(f"http://127.0.0.1:{port}/metrics")
    finally:
        server.stop()
    block = res.summary().get("slo") or {}
    rows = block.get("objectives") or {}
    if (res.slo is None or block != res.slo
            or any(rows.get(k, {}).get("verdict") != "ok"
                   for k in ("sdc_rate", "availability"))):
        fail(f"phase 31a: the flagship's SLO block is {block}")
    report = runner.metrics.slo_status()
    hub = doc.get("slo") or {}
    if (hub.get("verdict") != block["verdict"]
            or any(hub["objectives"][k]["observed"]
                   != rows[k]["observed"] for k in ("sdc_rate",
                                                    "availability"))
            or "coast_campaign_slo_verdict" not in prom):
        fail(f"phase 31a: /status carries {hub}, the result {block}")
    beats, panels = [], []
    obs.Heartbeat(n, interval_s=0.0, metrics=runner.metrics,
                  emit=beats.append).update(n, res.counts)
    obs.Console(n, interval_s=0.0, metrics=runner.metrics,
                emit=panels.append).final(n, res.counts)
    line = status_line(report)
    if not beats or not beats[-1].endswith(line) or \
            f"  {line}" not in panels[-1].splitlines():
        fail(f"phase 31a: heartbeat {beats[-1:]} / console do not carry "
             f"{line!r}")
    p99 = rows.get("p99_dispatch", {})
    k1, k2 = count()
    log(f"phase 31a: matrixMultiply1024 TMR {n} at {batch} with "
        f"slo={SLO31!r}: {res.counts}; verdict {block['verdict']} in "
        f"CampaignResult.slo, summary()['slo'], /status and /metrics; "
        f"heartbeat and console line {line!r}; sdc_rate observed "
        f"{rows['sdc_rate']['observed']} (burn {rows['sdc_rate']['burn_rate']}"
        f"), availability {rows['availability']['observed']}; p99_dispatch "
        f"{p99.get('observed')} s (the busy window's bucket bound, printed, "
        f"not compared); K1 {k1} [{card}]")

    # (b) ``python -m coast_tpu_torch slo check`` on the recorded summary:
    # exit 0 on an attained spec, 1 on a seeded burn (half the successes
    # recorded as SDCs).
    art = work / "phase31_run.json"
    art.write_text(json.dumps({"summary": res.summary(), "runs": []}))
    burnt = dict(res.summary())
    moved = int(burnt["success"]) // 2
    burnt["success"] -= moved
    burnt["sdc"] += moved
    burn_art = work / "phase31_burn.json"
    burn_art.write_text(json.dumps({"summary": burnt, "runs": []}))
    checks = [start_module("coast_tpu_torch", [
        "slo", "check", "--spec", spec, "--input", str(path)])
        for spec, path in ((SLO31, art), ("sdc_rate<=0.05;min=8", burn_art))]
    rcs = [finish_cli(p, "phase 31b: slo check", expect_ok=False)["rc"]
           for p in checks]
    if rcs != [0, 1]:
        fail(f"phase 31b: slo check exited {rcs}, want [0, 1]")
    log(f"phase 31b: python -m coast_tpu_torch slo check: attained spec "
        f"exit 0, seeded burn ({moved} successes recorded as SDC) exit 1")

    # (d) The driver.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = slo_smoke.main(["-d", "cuda"])
    if rc != 0 or buf.getvalue().splitlines()[-1:] != ["Success!"]:
        fail(f"phase 31d: slo_smoke -d cuda failed:\n{buf.getvalue()}")
    k1, k2 = count()
    log(f"phase 31d: slo_smoke -d cuda: Success! in "
        f"{time.perf_counter() - t0:.1f} s, K1 {k1} [{card}]")

    run = finish_cli(sup, "phase 31c: --slo")
    launches[0] += run["k1"]
    launches[1] += run["k2"]
    slo = (run["summary"] or {}).get("slo") or {}
    status = json.loads(sup_status.read_text())
    if slo.get("verdict") != "ok" or status.get("slo", {}).get(
            "verdict") != "ok":
        fail(f"phase 31c: the supervisor's --slo block is {slo}, its "
             f"status file's {status.get('slo')}")
    log(f"phase 31c: supervisor matrixMultiply -TMR -fuseStep 8192 at 2048 "
        f"--slo: verdict {slo['verdict']} in the summary and the status "
        f"file; K1 {run['k1']}, K2 {run['k2']} [{card}]")
    log(f"phase 31: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0 or launches[1] <= 0:
        fail(f"phase 31 launched K1 {launches[0]} and K2 {launches[1]} "
             "times")
    return tuple(launches)


def fleet_phase(work: Path, card: str, CampaignRunner, hv, hc) -> tuple:
    """Phase 32: the campaign fleet and trace federation on the card (see
    the module docstring).  Returns the (K1, K2) launches."""
    import contextlib
    import io
    from coast_tpu_torch.fleet import (CampaignQueue, CompileCache,
                                       codes_sha256, item_spec)
    from coast_tpu_torch.testing import profile_smoke
    t_phase = time.perf_counter()
    launches = [0, 0]

    def count() -> tuple:
        got = (hv.LAUNCHES, hc.LAUNCHES)
        launches[0] += got[0]
        launches[1] += got[1]
        hv.LAUNCHES = hc.LAUNCHES = 0
        return got

    hv.LAUNCHES = hc.LAUNCHES = 0
    # The driver runs as its own process beside the fleet below: both put
    # their workers on cuda:0.
    smoke = start_module("coast_tpu_torch.testing.fleet_smoke",
                         ["-d", "cuda"])
    # (a) Two items, drained by `fleet run --workers 2` on the card.  Each
    # batch is throttled by 0.5 s so that a kill lands mid-item.
    q = CampaignQueue(str(work / "phase32_queue"))
    specs = [item_spec("matrixMultiply", 16384, seed=s, batch_size=4096,
                       throttle_s=0.5) for s in (0, 1)]
    ids = [q.enqueue(spec) for spec in specs]
    mport = free_port()
    trace = work / "phase32_trace.json"
    fleet = start_module("coast_tpu_torch.fleet", [
        "run", "--queue", q.root, "--workers", "2", "--lease", "60",
        "--poll", "0.2", "-d", "cuda", "--metrics-port", str(mport),
        "--trace-out", str(trace)])
    victim = victim_item = None
    live_rates = False
    size_at_kill = 0
    deadline = time.time() + 240
    while time.time() < deadline and fleet.poll() is None:
        if not live_rates:
            try:
                prom = http_get(f"http://127.0.0.1:{mport}/metrics")
                live_rates = ("coast_fleet_class_rate" in prom
                              and not q.drained())
            except OSError:
                pass
        if victim is None:
            for rec in q.items("claimed"):
                jpath = q.journal_path(str(rec["id"]))
                if not os.path.exists(jpath):
                    continue
                if 1 <= count_batches(jpath) <= 2:
                    st = json.loads(Path(q.worker_status_path(
                        str(rec["worker"]))).read_text())
                    if st.get("item") != rec["id"]:
                        continue
                    victim, victim_item = st, str(rec["id"])
                    size_at_kill = os.path.getsize(jpath)
                    os.kill(int(st["pid"]), signal.SIGKILL)
                    break
        if victim is not None and live_rates:
            break
        time.sleep(0.05)
    if victim is None:
        fail("phase 32a: no worker journaled a batch to be killed in")
    run = finish_cli(fleet, "phase 32a: fleet run")
    if "parity ok" not in run["out"]:
        fail(f"phase 32a: fleet run printed no parity:\n{run['out']}")
    k1w, k2w, reports = worker_launches(run["err"])
    launches[0] += k1w
    launches[1] += k2w
    result = json.loads((Path(q.root) / "fleet_result.json").read_text())
    by_id = {item["id"]: item for item in result["items"]}
    if not live_rates:
        fail("phase 32a: /metrics never served fleet rates while the "
             "workers ran")
    if (by_id[victim_item]["attempts"] != 2
            or os.path.getsize(q.journal_path(victim_item)) <= size_at_kill):
        fail(f"phase 32a: the killed item {victim_item} was not resumed "
             f"by a replacement: {by_id[victim_item]}")
    if result["cache"]["hits"] < 1:
        fail(f"phase 32a: no compile-cache hit: {result['cache']}")
    # The same two campaigns in one process on the card.
    cache = CompileCache(str(work / "phase32_cache"), device="cuda")
    for item_id, spec in zip(ids, specs):
        runner, _, _, _ = cache.runner(spec)
        ref = runner.run(spec["n"], seed=spec["seed"],
                         batch_size=spec["batch_size"])
        got = by_id[item_id]
        if (got["codes_sha256"] != codes_sha256(ref.codes)
                or got["counts"] != {k: int(v)
                                     for k, v in ref.counts.items()}):
            fail(f"phase 32a: item {item_id} {got['counts']} differs from "
                 f"the in-process run {ref.counts}")
    names = {e["name"].split(" ")[0]
             for e in json.loads(trace.read_text())["traceEvents"]}
    if not {"enqueue", "claim", "complete", "dispatch"} <= names:
        fail(f"phase 32a: the federated trace holds {sorted(names)}")
    k1, k2 = count()
    log(f"phase 32a: fleet run --workers 2 on cuda:0, 2 x matrixMultiply "
        f"TMR 16384 at 4096 (seeds 0, 1): worker {victim['worker']} "
        f"SIGKILL'd in item {victim_item} and the journal resumed by its "
        f"replacement; per-item codes_sha256 and counts = the in-process "
        f"run ({result['totals']}); cache {result['cache']}; /metrics "
        f"served fleet rates live; federated trace written; workers "
        f"reported K1 {k1w}, K2 {k2w} ({reports} exits), in-process K1 "
        f"{k1} [{card}]")

    # (b) The drivers.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = profile_smoke.main(["-d", "cuda"])
    if rc != 0 or buf.getvalue().splitlines()[-1:] != ["Success!"]:
        fail(f"phase 32b: profile_smoke -d cuda failed:\n{buf.getvalue()}")
    k1, k2 = count()
    log(f"phase 32b: profile_smoke -d cuda: Success! in "
        f"{time.perf_counter() - t0:.1f} s, K1 {k1} [{card}]")
    run = finish_cli(smoke, "phase 32b: fleet_smoke -d cuda")
    out = run["out"].splitlines()
    if out[-1:] != ["Success!"]:
        fail(f"phase 32b: fleet_smoke -d cuda:\n{run['out']}")
    k1s, k2s, _ = worker_launches(run["err"])
    launches[0] += k1s + run["k1"]
    launches[1] += k2s + run["k2"]
    log(f"phase 32b: fleet_smoke -d cuda: Success! ({out[-2]}); its "
        f"workers K1 {k1s}, its own process K1 {run['k1']} [{card}]")
    log(f"phase 32: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0:
        fail(f"phase 32 launched K1 {launches[0]} times")
    return tuple(launches)


# -- phase 33: the protection-regression CI ---------------------------------

# The committed baseline's rows (its equivalence representatives): every
# one is re-injected, since its section fingerprints are the reference's.
CI_ROWS = {"crc16|-DWC|memory|s7": 13, "crc16|-TMR|memory|s7": 13,
           "matrixMultiply|-DWC|memory|s7": 535,
           "matrixMultiply|-TMR|memory|s7": 546}


def ci_phase(work: Path, card: str, hv, hc) -> tuple:
    """Phase 33: the protection-regression CI on the card (see the module
    docstring).  Returns the (K1, K2) launches."""
    import contextlib
    import io
    from coast_tpu_torch.ci.baseline import load_baseline
    from coast_tpu_torch.testing import ci_smoke
    t_phase = time.perf_counter()
    launches = [0, 0]
    hv.LAUNCHES = hc.LAUNCHES = 0
    # (a) `ci check` of the committed baseline as one process, started
    # first, with its two fleet workers on cuda:0.
    committed = ROOT / "artifacts" / "ci_baseline.json"
    refreshed = work / "phase33_refreshed.json"
    report_path = work / "phase33_report.json"
    check = start_module("coast_tpu_torch", [
        "ci", "check", "--baseline", str(committed), "--out",
        str(refreshed), "--workers", "2", "--device", "cuda",
        "--queue", str(work / "phase33_queue"),
        "--report-json", str(report_path)])
    # (b) The driver, in this process meanwhile.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ci_smoke.main(["-d", "cuda"])
    out = buf.getvalue().splitlines()
    if rc != 0 or out[-1:] != ["Success!"]:
        fail(f"phase 33b: ci_smoke -d cuda failed:\n{buf.getvalue()}")
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    log(f"phase 33b: ci_smoke -d cuda: Success! in "
        f"{time.perf_counter() - t0:.1f} s ({out[-2]}); K1 {hv.LAUNCHES}, "
        f"K2 {hc.LAUNCHES} [{card}]")
    hv.LAUNCHES = hc.LAUNCHES = 0

    run = finish_cli(check, "phase 33a: ci check")
    k1w, k2w, reports = worker_launches(run["err"])
    launches[0] += k1w + run["k1"]
    launches[1] += k2w + run["k2"]
    base = load_baseline(str(committed))["targets"]
    report = json.loads(report_path.read_text())
    got = {t["target"]: t for t in report["targets"]}
    if report["verdict"] != "pass" or set(got) != set(CI_ROWS):
        fail(f"phase 33a: ci check reported {report['verdict']} on "
             f"{sorted(got)}")
    for tid, rows in CI_ROWS.items():
        t = got[tid]
        if (t["reinjected_rows"], t["reused_rows"], t["dropped_rows"]) \
                != (rows, 0, 0) or t["counts"] != base[tid]["counts"]:
            fail(f"phase 33a: {tid} re-injected {t['reinjected_rows']} "
                 f"(reused {t['reused_rows']}) with {t['counts']}; the "
                 f"baseline holds {rows} rows and {base[tid]['counts']}")
    if set(load_baseline(str(refreshed))["targets"]) != set(CI_ROWS):
        fail("phase 33a: the refreshed baseline lacks targets")
    log(f"phase 33a: python -m coast_tpu_torch ci check --workers 2 "
        f"--device cuda of artifacts/ci_baseline.json: exit 0, PASS; "
        f"re-injected {[got[t]['reinjected_rows'] for t in CI_ROWS]} rows, "
        f"reused 0, counts = the baseline's on all 4 targets; campaign "
        f"seconds {[got[t]['seconds'] for t in CI_ROWS]}; {reports} "
        f"workers reported K1 {k1w}, K2 {k2w} [{card}]")
    log(f"phase 33: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0:
        fail(f"phase 33 launched K1 {launches[0]} times")
    return tuple(launches)


# -- phase 34: continuous-protection serving ---------------------------------

def serve_burst(engine, payloads, strategies=(None,)) -> tuple:
    """Submit ``payloads`` at once (SLA 30 s; strategy ``strategies[i %
    len]``, None for the engine's choice); returns (responses, per-request
    latencies in seconds, wall seconds).  Completion is polled every
    millisecond, so a latency is exact to about 1 ms."""
    t0 = time.perf_counter()
    reqs = [engine.submit(p, sla_s=30.0,
                          strategy=strategies[i % len(strategies)])
            for i, p in enumerate(payloads)]
    lat = {}
    while len(lat) < len(reqs):
        if time.perf_counter() - t0 > 120 or engine.error:
            fail(f"phase 34: requests stalled ({engine.error})")
        for req in reqs:
            if req.rid not in lat and req.done.is_set():
                lat[req.rid] = time.perf_counter() - t0
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    bad = [(r.rid, r.error) for r in reqs if r.response is None]
    if bad:
        fail(f"phase 34: requests not served: {bad}")
    return [r.response for r in reqs], sorted(lat.values()), wall


def serve_argv(jdir: Path, port: int, throttle: float) -> list:
    return ["serve", "matrixMultiply", "--port", str(port), "--device",
            "cuda", "--journal-dir", str(jdir), "--batch-size", "16",
            "--inject-share", "0.5", "--seed", "5", "--inject-n",
            str(SERVE_N), "--idle-throttle", str(throttle),
            "--duration", "300"]


# Phase 34b's standing campaign: 1024 rows a strategy, 8 a dispatch.
SERVE_N = 1024


def serve_phase(work: Path, card: str, hv, hc) -> tuple:
    """Phase 34: continuous-protection serving on the card (see the module
    docstring).  Returns the (K1, K2) launches."""
    import contextlib
    import io
    import urllib.request
    from coast_tpu_torch.analysis.propagation import prove_isolation
    from coast_tpu_torch.inject.campaign import run_classified
    from coast_tpu_torch.serve import ServeEngine
    from coast_tpu_torch.serve.engine import response_digest
    from coast_tpu_torch.testing import serve_smoke
    t_phase = time.perf_counter()
    launches = [0, 0]
    hv.LAUNCHES = hc.LAUNCHES = 0
    # (b) The serving process, started first; a throttled standing
    # campaign keeps its injection lanes running while it is probed.
    jdir = work / "phase34_serve"
    port = free_port()
    first = start_module("coast_tpu_torch", serve_argv(jdir, port, 0.1))
    # The uninterrupted run its codes are held to, in this process
    # meanwhile.
    t0 = time.perf_counter()
    with ServeEngine("matrixMultiply", batch_size=16, inject_share=0.5,
                     seed=5, inject_n=SERVE_N,
                     journal_dir=str(work / "phase34_fresh"),
                     device="cuda") as engine:
        if not engine.drain_injection(timeout_s=120.0):
            fail(f"phase 34b: the in-process run never drained "
                 f"({engine.error})")
        fresh = {s: engine.lane_codes(s) for s in ("DWC", "TMR")}
    fresh_s = time.perf_counter() - t0
    url = f"http://127.0.0.1:{port}"
    deadline = time.time() + 120
    while True:
        try:
            http_get(url + "/healthz")
            break
        except OSError:
            if first.poll() is not None or time.time() > deadline:
                fail(f"phase 34b: the serve process never answered "
                     f"(exit {first.poll()})")
            time.sleep(0.1)
    answers = []
    for i in range(8):
        req = urllib.request.Request(
            url + "/v1/infer", data=json.dumps(
                {"payload": f"http-{i}", "sla_s": 30.0}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            answers.append(json.loads(resp.read()))
    status = json.loads(http_get(url + "/status"))
    prom = http_get(url + "/metrics")
    dwc_journal = jdir / "serve-DWC.journal"
    while count_batches(dwc_journal) < 1:
        if first.poll() is not None:
            fail("phase 34b: the serve process died before journaling")
        time.sleep(0.02)
    os.killpg(first.pid, signal.SIGKILL)
    first.communicate()
    at_kill = {s: sum(r["n"] for r in journal_records(
        jdir / f"serve-{s}.journal") if r["kind"] == "batch")
        for s in ("DWC", "TMR")}
    if (any(a["class"] != "success" for a in answers)
            or status.get("format") != "coast-serve-status"
            or status["serving"]["requests"]["served"] < 8
            or "coast_serve_served_total" not in prom
            or "coast_serve_lane_leak_violations_total 0" not in prom):
        fail(f"phase 34b: answers {answers}, status "
             f"{status.get('serving')}")
    if not 0 < at_kill["DWC"] < SERVE_N:
        fail(f"phase 34b: the kill landed at {at_kill} of {SERVE_N} rows")
    # The restart on the same directory, unthrottled; (a) runs meanwhile.
    second = start_module("coast_tpu_torch",
                          serve_argv(jdir, free_port(), 0.0))

    # (a) Full width: matrixMultiply1024, both strategies.
    t0 = time.perf_counter()
    big = ServeEngine("matrixMultiply1024", batch_size=32, inject_share=0.5,
                      seed=11, inject_n=256,
                      journal_dir=str(work / "phase34_big"), device="cuda")
    build_s = time.perf_counter() - t0
    prover_s = {}
    for s, lane in big._lanes.items():
        t1 = time.perf_counter()
        proof = prove_isolation(lane.prog, strategy=s)
        prover_s[s] = round(time.perf_counter() - t1, 3)
        if not (lane.proof.holds and proof.holds) or proof.vacuous:
            fail(f"phase 34a: the {s} proof does not hold: "
                 f"{proof.format()}")
    with big:
        t0 = time.perf_counter()
        stream_on, _, _ = serve_burst(
            big, [f"req-{i:03d}" for i in range(10)])
        burst, lat, wall = serve_burst(
            big, [f"burst-{i:03d}" for i in range(32)], ("DWC", "TMR"))
        if not big.drain_injection(timeout_s=300.0):
            fail(f"phase 34a: injection never drained ({big.error})")
        inject_s = time.perf_counter() - t0
        doc = big.summary()
        codes = {s: big.lane_codes(s) for s in big._lanes}
    if any(r["class"] != "success" for r in burst + stream_on):
        fail(f"phase 34a: responses {burst}")
    srv = doc["serving"]
    if srv["lane_leak"]["violations"] or not srv["lane_leak"]["checks"]:
        fail(f"phase 34a: lane leak {srv['lane_leak']}")
    for s, lane in big._lanes.items():
        clean = response_digest(lane.prog.run_batch(batch=1)["output"])
        used = {r["digest"] for r in burst + stream_on
                if r["strategy"] == s}
        if used != {int(clean[0])}:
            fail(f"phase 34a: {s} digests {sorted(used)} differ from the "
                 f"fault-free run's {int(clean[0])}")
        want = np.concatenate([
            run_classified(lane.prog, lane.sched.slice(
                lo, lo + 128).device_arrays())["code"].cpu().numpy()
            for lo in range(0, 256, 128)])
        if not np.array_equal(codes[s], want):
            fail(f"phase 34a: {s} lane codes differ from run_batch of "
                 f"the same rows")
    with ServeEngine("matrixMultiply1024", batch_size=32, inject_share=0.0,
                     seed=11, inject_n=256, device="cuda") as off:
        stream_off, _, _ = serve_burst(
            off, [f"req-{i:03d}" for i in range(10)])
    if json.dumps(stream_on, sort_keys=True) \
            != json.dumps(stream_off, sort_keys=True):
        fail("phase 34a: the stream differs with injection lanes off")
    p99 = lat[min(len(lat) - 1, int(np.ceil(0.99 * len(lat))) - 1)]
    k1, k2 = hv.LAUNCHES, hc.LAUNCHES
    launches[0] += k1
    launches[1] += k2
    hv.LAUNCHES = hc.LAUNCHES = 0
    log(f"phase 34a: ServeEngine matrixMultiply1024 batch 32, "
        f"inject_share 0.5, 256 injections a strategy: built with both "
        f"proofs HOLDING in {build_s:.2f} s (prover {prover_s} s); 32 "
        f"requests served, all success, mix {srv['strategy_mix']}, "
        f"{len(burst) / wall:.3f} requests/s, p99 latency {p99:.4f} s "
        f"(max {lat[-1]:.4f} s); injection lanes "
        f"{srv['inject']['lanes_done']} at "
        f"{srv['inject']['lanes_done'] / inject_s:.2f} inj/s (the 10- and "
        f"32-request streams and the drain, {inject_s:.2f} s), counts "
        f"{doc['counts']}; digests = the fault-free run_batch's; lane "
        f"codes = run_batch of the same schedule rows; lane leaks 0 of "
        f"{srv['lane_leak']['checks']}; the 10-request stream "
        f"byte-identical with inject_share 0.0; K1 {k1}, K2 {k2} [{card}]")

    # (b) continued: the restarted process finishes the standing
    # campaigns; SIGTERM ends it cleanly.
    deadline = time.time() + 180
    while any(sum(r["n"] for r in journal_records(
            jdir / f"serve-{s}.journal") if r["kind"] == "batch") < SERVE_N
            for s in ("DWC", "TMR")):
        if second.poll() is not None or time.time() > deadline:
            fail(f"phase 34b: the restarted process did not finish "
                 f"(exit {second.poll()})")
        time.sleep(0.1)
    second.send_signal(signal.SIGTERM)
    run = finish_cli(second, "phase 34b: serve restart")
    launches[0] += run["k1"]
    launches[1] += run["k2"]
    for s in ("DWC", "TMR"):
        got = np.concatenate([np.asarray(r["codes"], np.int32)
                              for r in journal_records(
                                  jdir / f"serve-{s}.journal")
                              if r["kind"] == "batch"])
        if not np.array_equal(got, fresh[s]):
            fail(f"phase 34b: {s} codes after the kill and restart differ "
                 f"from the uninterrupted run")
    log(f"phase 34b: python -m coast_tpu_torch serve matrixMultiply "
        f"--device cuda: 8 POST /v1/infer all success, /status "
        f"coast-serve-status, /metrics coast_serve_*; SIGKILL'd at "
        f"{at_kill} of {SERVE_N} rows, restarted on the same journals: "
        f"{2 * SERVE_N} injection codes = the uninterrupted in-process "
        f"run ({fresh_s:.1f} s); the restart reported K1 {run['k1']}, K2 "
        f"{run['k2']} [{card}]")

    # (c) The driver.
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_smoke.main(["-d", "cuda"])
    out = buf.getvalue().splitlines()
    if rc != 0 or out[-1:] != ["Success!"]:
        fail(f"phase 34c: serve_smoke -d cuda failed:\n{buf.getvalue()}")
    launches[0] += hv.LAUNCHES
    launches[1] += hc.LAUNCHES
    log(f"phase 34c: serve_smoke -d cuda: Success! in "
        f"{time.perf_counter() - t0:.1f} s ({out[0]}); K1 {hv.LAUNCHES}, "
        f"K2 {hc.LAUNCHES} [{card}]")
    hv.LAUNCHES = hc.LAUNCHES = 0
    log(f"phase 34: {time.perf_counter() - t_phase:.1f} s, K1 "
        f"{launches[0]}, K2 {launches[1]} launches [{card}]")
    if launches[0] <= 0:
        fail(f"phase 34 launched K1 {launches[0]} times")
    return tuple(launches)


# Phase 35: the restricted-C front end on the card (ROADMAP item 17d, part
# 2): three sources of tests/c_sources and the fuzz tier.
C_SOURCES = ("mm9", "crc16", "gcd")
STUDIES = "coast_tpu_torch.scripts."
SWEEP_SEED = re.compile(r"# seed (\d+): gcc ([\d.]+) s, lift ([\d.]+) s, "
                        r"run ([\d.]+) s$")


def sweep_argv(work: Path) -> list:
    """The C-fuzz sweep of seeds 0-19 on the card in four workers, one
    chunk, its record under ``work``: ``c_fuzz -n 20 -j 4``'s seeds."""
    return [sys.executable, "-m", STUDIES + "c_fuzz_sweep", "--start", "0",
            "-n", "20", "--chunk", "20", "-d", "cuda", "-j", "4", "--out",
            str(work / "c_fuzz_sweep.json")]


def sweep_record(work: Path, rc: int, out: str, err: str) -> dict:
    """The sweep's record after a run that exited ``rc``: seeds 0-19 pass,
    no failure, the printed summary equal to the record."""
    with open(work / "c_fuzz_sweep.json") as fh:
        record = json.load(fh)
    printed = json.loads(out.strip().splitlines()[-1]) if out.strip() \
        else None
    if rc != 0 or record["ranges"] != [[0, 20]] or record["failures"] \
            or record["n_pass"] != 20 or record["generator"] != \
            "coast_tpu_torch/testing/c_fuzz.py" or printed != {
                "envelope_sha": record["envelope_sha"], "n_pass": 20,
                "n_fail": 0, "ranges": [[0, 20]]}:
        fail(f"c_fuzz_sweep exited {rc}: {out.strip()[-500:]} "
             f"{err.strip()[-1500:]}")
    return record


def c_oracle(name: str, path: Path) -> list:
    """The words a fault-free run of source ``name`` prints last, from the
    port's models (mm9: the XOR and 0 errors, crc16: the CRC) or, for
    gcd, from the arrays of its source."""
    import math
    if name == "mm9":
        from coast_tpu_torch.models import mm
        return [mm.make_region().meta["golden_xor"], 0]
    if name == "crc16":
        from coast_tpu_torch.models import crc16
        return [crc16.GOLDEN]
    text = path.read_text()
    arrays = []
    for key in ("a_in[N] = {", "b_in[N] = {"):
        body = text.split(key, 1)[1].split("}", 1)[0]
        arrays.append([int(w.rstrip("u"))
                       for w in body.replace(",", " ").split()])
    gs = [math.gcd(x, y) for x, y in zip(*arrays)]
    x = 0
    for g in gs:
        x ^= g
    return [x, sum(gs) & 0xFFFFFFFF]


def gcc_prints(path: Path, work: Path) -> list:
    exe = work / (path.stem + ".bin")
    got = subprocess.run(["gcc", "-O1", "-fwrapv", "-funsigned-char", "-w",
                          "-o", str(exe), str(path)], capture_output=True,
                         text=True, timeout=120)
    if got.returncode != 0:
        fail(f"gcc could not build {path.name}: {got.stderr.strip()}")
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=60)
    return [int(w) for w in out.stdout.split() if w.lstrip("-").isdigit()]


def c_frontend_phase(work: Path, card: str, TMR, DWC, CampaignRunner, hv,
                     hc, fs, n: int = 4096, cpu_rows: int = 512) -> tuple:
    """Phase 35: (a) the pycparser and gcc versions; (b) each source of
    ``tests/c_sources`` lifted on the card (``lift_c``): gcc's printed
    words equal the lifted fault-free output's last words and the oracle;
    TMR and DWC, ``n`` rows at ``n``, unfused and ``-fuseStep``: fused =
    unfused on every row, K1/K2 launches exactly their per-trip counts,
    the first ``cpu_rows`` rows equal a CPU rerun; (c) ``opt -TMR
    mm9.c`` and a supervisor campaign on crc16.c whose reference-format
    log names the source on line 1, as processes started at the phase's
    start; (d) the C-fuzz sweep of ``c_fuzz -n 20 -j 4``'s seeds
    (``sweep_argv``), started with them and left running: phase 36 reads
    it.  Returns the (K1, K2) launches and the sweep's process."""
    import pycparser

    from coast_tpu_torch.frontend import lift_c
    gcc = subprocess.run(["gcc", "--version"], capture_output=True,
                         text=True, timeout=60)
    if gcc.returncode != 0:
        fail("gcc is not on this machine")
    log(f"pycparser {pycparser.__version__}; "
        f"{gcc.stdout.splitlines()[0]} [{card}]")
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    src = {name: ROOT / "tests" / "c_sources" / f"{name}.c"
           for name in C_SOURCES}
    sup_dir = work / "c_crc16"
    sup_dir.mkdir()
    procs = {
        "opt": spawn([sys.executable, "-m", "coast_tpu_torch.opt", "-TMR",
                      "-countErrors", str(src["mm9"])], cwd=ROOT, env=env,
                     stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                     text=True),
        "fuzz": spawn(sweep_argv(work), cwd=ROOT, env=env,
                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                      text=True),
        "supervisor": start_cli(["-f", str(src["crc16"]), "-t", str(n),
                                 "--batch-size", str(n), "--seed", "1",
                                 "--log-format", "reference", "-l",
                                 str(sup_dir)], "gpu"),
    }
    launches = [0, 0]
    for name, path in src.items():
        t0 = time.perf_counter()
        region = lift_c(name, [str(path)])
        lifted_s = time.perf_counter() - t0
        final = region.run_unprotected("cuda")
        words = region.output({k: v.unsqueeze(0) for k, v in final.items()}
                              )[0].cpu().numpy().view(np.uint32)
        want = c_oracle(name, path)
        printed = gcc_prints(path, work)
        got = [int(w) for w in words[-len(want):]]
        if printed != want or got != want:
            fail(f"{name}.c: gcc prints {printed}, the lifted run on the "
                 f"card {got}, the oracle {want}")
        log(f"{name}.c: lifted in {lifted_s:.1f} s ({len(region.spec)} "
            f"leaves, {region.nominal_steps} steps), prints {got} = gcc's "
            f"= the oracle [{card}]")
        for strat in (TMR, DWC):
            label = f"{name}.c {strat.__name__}"
            results = {}
            for fused in (False, True):
                prog = strat(region, fuse_step=fused)
                trip, boundary, ops = sync_launches(prog, hv, fs)
                trips = count_trips(prog)
                hv.LAUNCHES = hc.LAUNCHES = 0
                t0 = time.perf_counter()
                res = CampaignRunner(prog, strategy_name=strat.__name__).run(
                    n, seed=1, batch_size=n)
                wall = time.perf_counter() - t0
                got_l = (hv.LAUNCHES, hc.LAUNCHES)
                want_l = (trip[0] * trips[0] + boundary, trip[1] * trips[0])
                if got_l != want_l:
                    fail(f"{label} fused={fused}: K1/K2 launches {got_l}, "
                         f"not {want_l}")
                if strat is TMR and fused and got_l[1] <= 0:
                    fail(f"{label} -fuseStep launched K2 no time")
                if got_l[0] <= 0 and not fused:
                    fail(f"{label} launched K1 no time")
                launches[0] += got_l[0]
                launches[1] += got_l[1]
                results[fused] = res
                log(f"{label}{' -fuseStep' if fused else ''}: {res.counts} "
                    f"{res.injections_per_sec:.1f} inj/s ({wall:.2f} s wall),"
                    f" {trips[0]} trips of {ops} torch ops, K1 {got_l[0]}, "
                    f"K2 {got_l[1]} [{card}]")
            why = records_differ(results[False], results[True])
            if why:
                fail(f"{label}: fused and unfused records differ: {why}")
            dense = results[False]
            sub = dense.schedule.slice(0, cpu_rows)
            t0 = time.perf_counter()
            cpu = CampaignRunner(strat(region, device="cpu")).run_schedule(
                sub, batch_size=cpu_rows)
            cpu_s = time.perf_counter() - t0
            for col in COLUMNS:
                bad = getattr(dense, col)[:cpu_rows] != getattr(cpu, col)
                if bad.any():
                    fail(f"{label}: {col} differs between the card and the "
                         f"CPU on rows {np.flatnonzero(bad)[:10].tolist()}")
            log(f"{label}: fused = unfused on every row, the first "
                f"{cpu_rows} rows equal the CPU's ({cpu_s:.1f} s) [{card}]")

    out, err = procs["opt"].communicate(timeout=600)
    if procs["opt"].returncode != 0 or "E: 0" not in out:
        fail(f"opt -TMR mm9.c exited {procs['opt'].returncode}: "
             f"{out.strip()[-500:]} {err.strip()[-1500:]}")
    log(f"python -m coast_tpu_torch.opt -TMR -countErrors mm9.c: "
        f"{out.strip().splitlines()[-1]} [{card}]")
    cli = finish_cli(procs["supervisor"], "supervisor -f crc16.c")
    launches[0] += cli["k1"]
    launches[1] += cli["k2"]
    log_path = sup_dir / "crc16_TMR_memory.json"
    with open(log_path) as fh:
        line1 = fh.readline().strip()
        rows = json.load(fh)
    if line1 != os.path.realpath(src["crc16"]) or len(rows) != n:
        fail(f"supervisor -f crc16.c: line 1 {line1!r}, {len(rows)} rows")
    log(f"supervisor -f crc16.c -t {n}: {cli['summary']['injections']} "
        f"injections, line 1 of the reference-format log names the "
        f"source, K1 {cli['k1']} [{card}]")
    return tuple(launches), procs["fuzz"]


def sweep_read(work: Path, card: str, proc: subprocess.Popen,
               t_start: float) -> None:
    """Phase 35's C-fuzz sweep: its record (seeds 0-19 pass, no failure)
    and its seeds' gcc, lift and run seconds, summed over its workers."""
    out, err = proc.communicate(timeout=600)
    record = sweep_record(work, proc.returncode, out, err)
    sums = [0.0, 0.0, 0.0]
    for line in err.splitlines():
        m = SWEEP_SEED.match(line)
        if m:
            for j in range(3):
                sums[j] += float(m.group(j + 2))
    log(f"35d: python -m coast_tpu_torch.scripts.c_fuzz_sweep -n 20 -d "
        f"cuda -j 4: seeds {record['ranges']} pass, no failure, read "
        f"{time.perf_counter() - t_start:.1f} s after its start; its seeds "
        f"summed over its 4 workers: gcc {sums[0]:.2f} s, lift "
        f"{sums[1]:.2f} s, run {sums[2]:.2f} s [{card}]")


MWTF_N = 20000
# The rows of each integer MWTF campaign on the card rerun on the CPU.
STUDY_CPU_ROWS = {"matrixMultiply": 512, "crc16": 512}
# train_campaign's injections a strategy: 1,024 of the reference's 2,048.
TRAIN_N = 1024
WORKFLOW = ROOT / "coast_tpu_torch" / "scripts" / "zero_to_aha.sh"


def ratio(a: float, b: float) -> str:
    if b == 0:
        return "inf" if a > 0 else "1"
    return f"{a / b:.4f}"


def mwtf_rows(record: dict, card: str, label: str = "") -> None:
    """One line a protected strategy: counts, MWTF, the SDC and DUE rates
    against unprotected's, and each program's seconds a fault-free run."""
    from coast_tpu_torch.inject import classify as cls
    for name, row in record["benchmarks"].items():
        camp = row["campaigns"]
        base = camp["unprotected"]
        n = sum(base.values())
        sdc = {s: sum(c.get(k, 0) for k in cls.SDC_CLASSES)
               for s, c in camp.items()}
        due = {s: sum(c.get(k, 0) for k in cls.DUE_CLASSES)
               for s, c in camp.items()}
        log(f"36a {name}{label}: unprotected "
            f"{ {k: v for k, v in base.items() if v} } of {n}, "
            f"{row['seconds_per_run']['unprotected']} s a run; flops "
            f"overhead {row.get('flops_overhead')} "
            f"({row['flops_overhead_source']}) [{card}]")
        for strat in camp:
            if strat == "unprotected":
                continue
            vs = row[f"vs_unprotected_{strat}"]
            log(f"36a {name}{label} {strat}: "
                f"{ {k: v for k, v in camp[strat].items() if v} }, MWTF "
                f"{vs['mwtf']}, SDC ratio "
                f"{ratio(sdc[strat], sdc['unprotected'])}, DUE ratio "
                f"{ratio(due[strat], due['unprotected'])}, "
                f"runtime x{vs['runtime_x']}, "
                f"{row['seconds_per_run'][strat]} s a run [{card}]")


def study(module: str, out: Path, *argv, env=None) -> tuple:
    """Run ``coast_tpu_torch.scripts.<module>``'s ``main`` in this process
    with ``--out out`` (its printed lines go to ``out`` + ``.log``) ->
    (its exit code, the (K1, K2) launches it made, its record, seconds)."""
    import contextlib
    import importlib
    from coast_tpu_torch.ops import hopper_commit as hc
    from coast_tpu_torch.ops import hopper_voters as hv
    mod = importlib.import_module(STUDIES + module)
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    hv.LAUNCHES = hc.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        with open(f"{out}.log", "w") as fh, contextlib.redirect_stdout(fh), \
                contextlib.redirect_stderr(fh):
            rc = mod.main([str(a) for a in argv] + ["--out", str(out)])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t0
    if rc != 0:
        with open(f"{out}.log") as fh:
            fail(f"phase 36: {module} {list(argv)} exited {rc}: "
                 f"{fh.read()[-2500:]}")
    with open(out) as fh:
        record = json.load(fh)
    return rc, (hv.LAUNCHES, hc.LAUNCHES), record, seconds


def start_workflow(work: Path) -> subprocess.Popen:
    """``zero_to_aha.sh -d cuda`` on mm9.c with 512 injections: a chain of
    processes (each lifts the source), one host thread each, its output
    in ``work/zero_to_aha.{out,err}``."""
    with open(work / "zero_to_aha.out", "w") as out, \
            open(work / "zero_to_aha.err", "w") as err:
        return spawn(["sh", str(WORKFLOW), "-d", "cuda",
                      str(ROOT / "tests" / "c_sources" / "mm9.c"), "512"],
                     cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT),
                                    "OMP_NUM_THREADS": "1"},
                     stdout=out, stderr=err)


def studies_phase(work: Path, card: str, TMR, DWC, unprotected, REGISTRY,
                  CampaignRunner, hv, hc, sweep, t_sweep: float,
                  workflow: subprocess.Popen) -> tuple:
    """Phase 36: the reliability studies of ``coast_tpu_torch/scripts`` on
    the card.  This process calls each study's ``main`` one after another
    and holds its record, and reruns the integer MWTF campaigns on the
    card with their first rows on the CPU.  Then it reads phase 35's
    C-fuzz sweep (``sweep``, started at ``t_sweep``), runs it again on
    its record, and reads the workflow (``start_workflow``, started
    after phase 15).  Returns the (K1, K2) launches."""
    from coast_tpu_torch.inject import classify as cls
    sdir = work / "studies"
    sdir.mkdir()
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    launches = [0, 0]
    records = {}

    def run(key, module, *argv, env=None):
        _, got, records[key], seconds = study(module, sdir / f"{key}.json",
                                              *argv, env=env)
        launches[0] += got[0]
        launches[1] += got[1]
        log(f"36: {' '.join(map(str, (module,) + argv))}: exit 0 in "
            f"{seconds:.1f} s, K1 {got[0]}, K2 {got[1]} [{card}]")
        return got

    # (a) The integer MWTF campaigns on the card in this process, their
    # first rows rerun on the CPU in worker processes while the studies
    # run.
    n = MWTF_N
    cards, reruns = {}, []
    for name, rows in STUDY_CPU_ROWS.items():
        region = REGISTRY[name]()
        for strat in (unprotected, DWC, TMR):
            hv.LAUNCHES = hc.LAUNCHES = 0
            res = CampaignRunner(strat(region),
                                 strategy_name=strat.__name__).run(
                n, seed=2026, batch_size=n)
            launches[0] += hv.LAUNCHES
            launches[1] += hc.LAUNCHES
            if strat is not unprotected and hv.LAUNCHES <= 0:
                fail(f"36a {name} {strat.__name__} launched K1 no time")
            cards[name, strat.__name__] = res
            reruns.append((name, strat.__name__, rows, rerun_pool().submit(
                cpu_rerun, name, strat, {}, res.schedule.slice(0, rows),
                rows)))
    # The MWTF reports: their integer counts are this process's card
    # campaigns of the same seed and the reference's recorded campaigns
    # (seed-determined); the fused engine's the unfused one's.
    run("mwtf", "mwtf_report", "--benchmarks", "mm,crc16", "-n", n,
        "--batch", n)
    if run("mwtf_fused", "mwtf_report", "--benchmarks", "mm,crc16", "-n", n,
           "--batch", n, "--fuse-step")[1] <= 0:
        fail("36a: the fused report launched K2 no time")
    if run("mwtf_1024", "mwtf_report", "--benchmarks", "matrixMultiply1024",
           "-n", 512, "--batch", 128)[0] <= 0:
        fail("36a: the flagship's report launched K1 no time")
    for key in ("mwtf", "mwtf_fused", "mwtf_1024"):
        if records[key]["device"]["name"] + ", " + \
                records[key]["device"]["power_limit"] != card:
            fail(f"36a {key}: the record names {records[key]['device']}")
    with open(ROOT / "artifacts" / "mwtf_report.json") as fh:
        recorded = json.load(fh)["benchmarks"]
    for (name, strat), res in cards.items():
        want = recorded[name]["campaigns"][strat]
        got = [res.counts] + [records[key]["benchmarks"][name]["campaigns"][
            strat] for key in ("mwtf", "mwtf_fused")
            if name in records[key]["benchmarks"]]
        if any(c.get(k, 0) != want.get(k, 0) for c in got
               for k in set(c) | set(want)):
            fail(f"36a {name} {strat}: counts {got}, the record {want}")
    mwtf_rows(records["mwtf"], card)
    mwtf_rows(records["mwtf_fused"], card, " --fuse-step")
    mwtf_rows(records["mwtf_1024"], card)

    # (b) The fault-model sweep: every series monotone.
    run("faultmodel", "mwtf_report", "--model-sweep", "--benchmarks", "mm",
        "-n", 4096, "--batch", 4096)
    for strat, fams in records["faultmodel"]["degradation"].items():
        for fam, d in fams.items():
            if not d["monotone_uncorrected"]:
                fail(f"36b {strat} {fam}: not monotone: {d['series']}")
            log(f"36b mm {strat} {fam}: uncorrected "
                f"{[x['uncorrected'] for x in d['series']]} over "
                f"{[x['model'] for x in d['series']]}, degradation "
                f"x{d['degradation_x']} [{card}]")

    # (c) The fidelity study: C1-C4 pass (its exit code); its tables beside
    # the record's.
    run("fidelity", "fidelity_study", env={"COAST_FIDELITY_BUDGET": "14000"})
    fid = records["fidelity"]
    with open(ROOT / "artifacts" / "fidelity_study.json") as fh:
        fid_rec = json.load(fh)
    for prog in ("unprotected", "TMR"):
        for sec, row in fid["sections"][prog].items():
            want = fid_rec["sections"][prog][sec]
            keys = ("n",) + cls.CLASS_NAMES
            log(f"36c {prog} {sec}: card "
                f"{ {k: row[k] for k in keys if row[k]} }, recorded "
                f"{ {k: want[k] for k in keys if want.get(k)} } [{card}]")
    for check in fid["checks"]:
        log(f"36c {check['name']}: pass, {check['detail']} [{card}]")

    # (d) Classification parity (its exit code: no differing row outside
    # the f32 exemption): bit for bit on the integer regions.
    run("parity", "classification_parity", "-n", 4096)
    par = records["parity"]
    for name in ("matrixMultiply", "crc16"):
        block = par["benchmarks"][name]
        if not all(block[f]["identical"] for f in ("codes", "errors",
                                                   "steps")):
            fail(f"36d {name}: the card's columns differ from the CPU's: "
                 f"{block}")
    mm256 = par["benchmarks"]["matrixMultiply256"]
    log(f"36d: codes, errors and steps of matrixMultiply and crc16 (4096 "
        f"rows) bit-identical on the card and the CPU; matrixMultiply256 "
        f"({mm256['codes']['n']} rows): exempt rows that differ "
        f"{mm256['exempt_rows']}, other rows that differ "
        f"{mm256['differing_rows']} [{card}]")

    # (e) The training campaign's three bars (its exit code).
    run("train", "train_campaign", "-n", TRAIN_N)
    train = records["train"]
    for strat, row in train["strategies"].items():
        log(f"36e {strat}: {row['rates']}, flops x{row['flops_overhead']}"
            f" [{card}]")
    log(f"36e: differential bit-identical "
        f"{train['differential']['fault_free_trajectory_bit_identical']} "
        f"(Adam {train['differential']['adam_variant_bit_identical']}), "
        f"{train['selective_vs_tmr']} [{card}]")

    for name, strat, rows, rerun in reruns:
        cpu = rerun.result()
        for col in COLUMNS:
            bad = getattr(cards[name, strat], col)[:rows] != cpu[col]
            if bad.any():
                fail(f"36a {name} {strat}: {col} differs between the card "
                     f"and the CPU on rows "
                     f"{np.flatnonzero(bad)[:10].tolist()}")
    close_rerun_pool()
    log(f"36a: the integer MWTF campaigns (20,000 rows, seed 2026) of the "
        f"reports, unfused and fused, and of this process equal the counts "
        f"of artifacts/mwtf_report.json, their first {STUDY_CPU_ROWS} rows "
        f"the CPU's [{card}]")

    # (f) Phase 35's sweep; run again on its record it skips every seed;
    # the workflow ends in exit 0.
    sweep_read(work, card, sweep, t_sweep)
    resume = spawn(sweep_argv(work), cwd=ROOT, env=env,
                   stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out, err = resume.communicate(timeout=600)
    sweep_record(work, resume.returncode, out, err)
    if any(SWEEP_SEED.match(line) for line in err.splitlines()):
        fail(f"36f: the resumed sweep ran seeds again: {err}")
    t0 = time.perf_counter()
    workflow.wait(timeout=900)
    out = (work / "zero_to_aha.out").read_text()
    err = (work / "zero_to_aha.err").read_text()
    if workflow.returncode != 0:
        fail(f"36f: zero_to_aha.sh -d cuda exited {workflow.returncode}: "
             f"{out.strip()[-1500:]} {err.strip()[-2500:]}")
    log(f"36f: the resumed c_fuzz_sweep ran no seed; zero_to_aha.sh -d "
        f"cuda mm9.c 512 exit 0 ({time.perf_counter() - t0:.1f} s waited "
        f"for it): {out.strip().splitlines()[-1]} [{card}]")
    return tuple(launches)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a card")
    try:
        from coast_tpu_torch import DWC, TMR, build, unprotected
        from coast_tpu_torch.inject.campaign import CampaignRunner
        from coast_tpu_torch.inject.device_gen import DeviceScheduleGen
        from coast_tpu_torch.inject.logs import StreamLogWriter
        from coast_tpu_torch.inject.mem import MemoryMap
        from coast_tpu_torch.inject.schedule import FaultModel, generate
        from coast_tpu_torch.interop import fault_from_numpy
        from coast_tpu_torch.models import REGISTRY
        from coast_tpu_torch.models.mm256 import order_sensitive
        from coast_tpu_torch.ops import fused_step as fs
        from coast_tpu_torch.ops import hopper_commit as hc
        from coast_tpu_torch.ops import hopper_voters as hv
        from coast_tpu_torch.ops import voters
        from coast_tpu_torch.ops.bitflip import noop_fault
        from coast_tpu_torch.passes.dataflow_protection import _repair
    except ImportError as e:
        fail(f"coast_tpu_torch is not importable ({e}); run from the root of "
             "a checkout")
    if "jax" in sys.modules or any(m.startswith("coast_tpu.")
                                   for m in sys.modules):
        fail("the port pulled in jax or the coast_tpu package")
    become_subreaper()
    # A run cut from outside (SIGTERM) or past its 1,200 s limit stops
    # its children itself rather than leave them running.
    signal.signal(signal.SIGTERM, lambda *_: fail("terminated (SIGTERM)"))
    signal.signal(signal.SIGALRM,
                  lambda *_: fail(f"still running after {DEADLINE_S} s"))
    signal.alarm(DEADLINE_S)

    # 1. Card and versions.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t_start = t_lap = time.perf_counter()

    def lap(what: str) -> None:
        """The wall time since the last lap: where the script's time goes
        against its limit."""
        nonlocal t_lap
        now = time.perf_counter()
        log(f"wall {what}: {now - t_lap:.1f} s [{card}]")
        name_strays(what)
        t_lap = now

    # 2. Build.
    t0 = time.perf_counter()
    outputs = build.build_all()
    log(f"built {sorted(outputs)} in {time.perf_counter() - t0:.1f} s")
    for name, out in outputs.items():
        for line in out.strip().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    lap("phase 2")
    # 3. K1 against its plain version, its time per leaf and per group.
    worst = check_k1(torch, hv, voters)
    later = []       # device-only timings, run in phase 18
    k1 = time_k1(torch, later, hv, voters)
    k1["max_abs_err"] = max(k1["max_abs_err"], worst)
    k1["shapes"] = time_k1_groups(torch, later, hv, voters, TMR, DWC,
                                  REGISTRY, card) + k1["shapes"]

    lap("phase 3")
    # 4. Main path: matrixMultiply1024 under TMR and DWC on the card.
    region = REGISTRY["matrixMultiply1024"]()
    results = {}
    hv.LAUNCHES = 0
    for strat in (TMR, DWC):
        prog = strat(region)
        rec = prog.run(noop_fault())
        clean = (int(rec["errors"]) == 0 and bool(rec["done"])
                 and int(rec["steps"]) == 16 and int(rec["corrected"]) == 0
                 and not bool(rec["dwc_fault"]))
        if not clean:
            fail(f"{strat.__name__} fault-free record is not clean: "
                 f"{ {k: v.tolist() for k, v in rec.items() if v.dim() == 0} }")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # The campaign's own peak: phase 18's inputs are held meanwhile.
        held = torch.cuda.memory_allocated()
        before = hv.LAUNCHES
        res = CampaignRunner(prog, strategy_name=strat.__name__).run(
            1024, seed=1, batch_size=128)
        launches = hv.LAUNCHES - before
        if launches <= 0:
            fail(f"the {strat.__name__} campaign launched K1 no time")
        if sum(v for k, v in res.counts.items() if k != "cache_invalid") \
                != res.n:
            fail(f"{strat.__name__} counts do not sum to {res.n}")
        log(f"matrixMultiply1024 {strat.__name__}: {res.counts} "
            f"{res.injections_per_sec:.1f} inj/s ({res.seconds:.2f} s), "
            f"peak {(torch.cuda.max_memory_allocated() - held) / 2**30:.2f}"
            f" GiB, "
            f"K1 launches {launches} [{card}]")
        results[strat] = res
    main_launches = hv.LAUNCHES
    if main_launches <= 0:
        fail("the main path launched K1 no time")

    # 5. Cross-check against the CPU (plain voters).
    exempt_total = exempt_differ = 0
    for strat, res in results.items():
        sub = res.schedule.slice(0, 8)
        cpu_prog = strat(region, device="cpu")
        cpu = CampaignRunner(cpu_prog).run_schedule(sub, batch_size=8)
        exempt = order_sensitive(cpu_prog.leaf_order, sub.leaf_id, sub.bit)
        exempt_total += int(exempt.sum())
        differ = np.zeros(8, bool)
        for col in ("codes", "errors", "corrected", "steps"):
            differ |= getattr(res, col)[:8] != getattr(cpu, col)
            if differ[~exempt].any():
                fail(f"{strat.__name__} {col} differ between card and CPU: "
                     f"{getattr(res, col)[:8]} vs {getattr(cpu, col)}")
        exempt_differ += int(differ.sum())
    log(f"CPU cross-check: 16 rows, {exempt_total} exempt (mantissa flips "
        f"of first/second/acc), the rest equal; {exempt_differ} of the "
        "exempt rows differ")

    lap("phases 4-5")
    # 6. matrixMultiply (9x9) TMR, the bench workload.
    hv.LAUNCHES = 0
    mm = CampaignRunner(TMR(REGISTRY["matrixMultiply"]()),
                        strategy_name="TMR").run(16384, seed=1,
                                                 batch_size=4096)
    log(f"matrixMultiply TMR: {mm.counts} {mm.injections_per_sec:.1f} inj/s "
        f"({mm.seconds:.2f} s), K1 launches {hv.LAUNCHES} [{card}]")

    lap("phase 6")
    # 7. The fused engine and K2.
    k2 = time_k2(torch, later, fs, hv, _repair, card)
    k2["max_abs_err"] = max(k2["max_abs_err"], check_k2(torch, fs))
    k2["shapes"] = time_k2_groups(torch, later, fs, TMR, REGISTRY, card) \
        + k2["shapes"]
    hv.LAUNCHES = hc.LAUNCHES = 0
    fused_path(torch, TMR, DWC, CampaignRunner, REGISTRY, hv, hc, card)
    fused_launches = hc.LAUNCHES
    if fused_launches <= 0 or hv.LAUNCHES <= 0:
        fail("the fused path launched K1 or K2 no time")
    big = TMR(region, fuse_step=True)
    if big._fuse_plan is not None or big.fuse_plan_info.exact_dataflow:
        fail("matrixMultiply1024 (float32 leaves) built a fused plan")
    log("matrixMultiply1024 TMR fuse_step=True: no fused plan (float "
        "leaves), the unfused program runs")

    lap("phase 7")
    # 8-13. Multi-site fault models and the sparse collect.
    check_generator(torch, TMR, REGISTRY, MemoryMap, FaultModel, generate,
                    DeviceScheduleGen, card)
    million_launches, bare = million(torch, TMR, REGISTRY, CampaignRunner,
                                     hv, hc, card)
    new_launches = [million_launches,
                    flagship_sparse(torch, TMR, DWC, CampaignRunner,
                                    FaultModel, REGISTRY, results, hv, hc,
                                    card),
                    grouped(torch, TMR, DWC, CampaignRunner, FaultModel,
                            REGISTRY, hv, hc, card),
                    overflow(TMR, CampaignRunner, REGISTRY, hv, hc, card)]
    sparse_times = sparse_batch_times(
        torch, TMR, REGISTRY, CampaignRunner, FaultModel, generate,
        DeviceScheduleGen, fault_from_numpy, card)
    log(json.dumps({"sparse_batch_ms": sparse_times}))
    lap("phases 8-13")
    # 14-17. The supervisor CLI: kill and resume, out-of-memory
    # degradation, the watchdog, and what durability costs at 10^6.
    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # 32,768 injections, an eighth of the earlier 262,144: phase 35
    # needed the time (8 batches a campaign still hold the kill at
    # batch 4).
    cli_launches, first = kill_resume(work, "gpu", card, n=32768, kill_at=4)
    new_launches += [
        cli_launches,
        oom_degrade(work, "gpu", card, torch, TMR, REGISTRY, CampaignRunner,
                    order_sensitive)]
    # Phase 36's workflow, a chain of processes each lifting a C source on
    # the host, runs from here on beside phases 16-20: after phase 15,
    # whose batch takes the card's memory until it fails.
    workflow = start_workflow(work)
    new_launches += [
        watchdog(work, "gpu", card, first),
        durability(work, "gpu", card, TMR, REGISTRY, CampaignRunner,
                   StreamLogWriter, bare)]
    lap("phases 14-17")
    # 19. The BASELINE regions: aes, sha256, quicksort and the CHStone
    # suite.
    # Its CPU reruns cover 64 rows a case, and its campaigns 1,024
    # injections (2,048 until phase 35 took the time): the script's limit.
    new_launches.append(baseline_regions(
        work, "gpu", card, torch, TMR, DWC, REGISTRY, CampaignRunner, hv, hc,
        fs, n=1024, cpu_rows=64))
    lap("phase 19")
    # 20. The rest of the registry: the corpus, the float regions and
    # towersOfHanoi with -protectStack.  Phases 20-23 rerun 64 rows a
    # case on the CPU (256 until phase 35 needed the time).
    new_launches.append(corpus_regions(
        work, "gpu", card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc, fs,
        cpu_rows=64))
    lap("phase 20")
    # 21. BASELINE config 5: CFCSS stacked with TMR.
    new_launches.append(cfcss_regions(
        "gpu", card, TMR, REGISTRY, CampaignRunner, hv, hc, fs,
        order_sensitive, cpu_rows=64))
    lap("phase 21")
    # 22. Function scope, segmented scheduling and the CFCSS CLI.
    new_launches.append(scope_regions(
        work, "gpu", card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc, fs,
        cpu_rows=64))
    lap("phase 22")
    # 23. The preemptive RTOS kernel targets with their guards.
    new_launches.append(rtos_kernel_targets(
        work, "gpu", card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc, fs,
        cpu_rows=64))
    lap("phase 23")
    # 24. The protected training step.
    new_launches.append(train_regions(
        "gpu", card, torch, DWC, TMR, unprotected, REGISTRY, CampaignRunner,
        hv, hc, fs))
    close_rerun_pool()
    lap("phase 24")
    # 25. The sharded backend on the stencil.
    new_launches.append(sharded_stencil(
        work, "gpu", card, torch, TMR, DWC, CampaignRunner, hv, hc, fs))
    lap("phase 25")
    # 26. The log parser and the replication-integrity linter on the card,
    # and the --unroll repair.
    new_launches.append(parse_and_lint(
        work, card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc, bare))
    lap("phase 26")
    # 27. Equivalence-reduced and delta campaigns.
    new_launches.append(equiv_campaigns(
        work, "gpu", card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc))
    lap("phase 27")
    # 28. The vulnerability map, the isolation prover, the static budget
    # and the advisor.
    phase28 = propagation_phase(work, card, TMR, DWC, REGISTRY,
                                CampaignRunner, hv, hc, results)
    new_launches.append(phase28)
    lap("phase 28")
    # 29. The region lifters, the fuzz tier, the harness and the drivers.
    phase29 = lifted_phase(card, TMR, DWC, REGISTRY, CampaignRunner, hv, hc)
    new_launches.append(phase29)
    lap("phase 29")
    # 30. Observability: the profiled flagship campaign, the live surfaces,
    # the trace, the drivers and what telemetry costs.
    phase30 = observability_phase(work, card, torch, TMR, REGISTRY,
                                  CampaignRunner, hv, hc)
    new_launches.append(phase30)
    lap("phase 30")
    # 31. Reliability SLOs and the verb dispatcher.
    phase31 = slo_phase(work, card, TMR, REGISTRY, CampaignRunner, hv, hc)
    new_launches.append(phase31)
    lap("phase 31")
    # 32. The campaign fleet and trace federation.
    phase32 = fleet_phase(work, card, CampaignRunner, hv, hc)
    new_launches.append(phase32)
    lap("phase 32")
    # 33. The protection-regression CI.
    phase33 = ci_phase(work, card, hv, hc)
    new_launches.append(phase33)
    lap("phase 33")
    # 34. Continuous-protection serving.
    phase34 = serve_phase(work, card, hv, hc)
    new_launches.append(phase34)
    lap("phase 34")
    # 35. The restricted-C front end: three C sources and the fuzz tier.
    t_sweep = time.perf_counter()
    phase35, sweep = c_frontend_phase(work, card, TMR, DWC, CampaignRunner,
                                      hv, hc, fs)
    new_launches.append(phase35)
    lap("phase 35")
    # 36. The reliability studies of coast_tpu_torch/scripts, beside the
    # end of phase 35's sweep.
    phase36 = studies_phase(work, card, TMR, DWC, unprotected, REGISTRY,
                            CampaignRunner, hv, hc, sweep, t_sweep, workflow)
    new_launches.append(phase36)
    lap("phase 36")
    shutil.rmtree(work)
    main_launches += sum(k1 for k1, _ in new_launches)
    fused_launches += sum(k2 for _, k2 in new_launches)

    # 18. Device-only times, after every campaign (see defer_device_ms).
    for name, record, key, fn in later:
        record[key] = device_ms(torch, fn)
        log(f"{name} {record['shape']}: {key} {fmt_ms(record[key])} a call "
            f"(torch.profiler, 200 calls) [{card}]")
    later.clear()
    lap("phase 18")
    log(f"wall in all: {time.perf_counter() - t_start:.1f} s [{card}]")

    log(json.dumps({"kernels": [{
        "name": "vote",
        "route": "cuda",
        "source": "coast_tpu_torch/csrc/vote.cu",
        "replaces": "coast_tpu/ops/pallas_voters.py:87",
        "launches": main_launches,
        "launches_phase_28": phase28[0],
        "launches_phase_29": phase29[0],
        "launches_phase_30": phase30[0],
        "launches_phase_31": phase31[0],
        "launches_phase_32": phase32[0],
        "launches_phase_33": phase33[0],
        "launches_phase_34": phase34[0],
        "launches_phase_35": phase35[0],
        "launches_phase_36": phase36[0],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": k1["shapes"],
    }, {
        "name": "commit",
        "route": "cuda",
        "source": "coast_tpu_torch/csrc/commit.cu",
        "replaces": "coast_tpu/ops/fused_step.py:373",
        "launches": fused_launches,
        "launches_phase_28": phase28[1],
        "launches_phase_29": phase29[1],
        "launches_phase_30": phase30[1],
        "launches_phase_31": phase31[1],
        "launches_phase_32": phase32[1],
        "launches_phase_33": phase33[1],
        "launches_phase_34": phase34[1],
        "launches_phase_35": phase35[1],
        "launches_phase_36": phase36[1],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": k2["shapes"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
