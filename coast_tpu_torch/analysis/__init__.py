"""Results analysis (the reference's simulation/platform/jsonParser.py)
and the replication-integrity linter (:mod:`.lint`)."""

from coast_tpu_torch.analysis.json_parser import (  # noqa: F401
    Summary, classify_run, compare_runs, cycle_histogram, read_json_file,
    section_stats, summarize_path, summarize_runs)
