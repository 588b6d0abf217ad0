#!/bin/sh
# The complete workflow, end to end, from a C source file, on the port
# (the counterpart of the reference's scripts/zero_to_aha.sh):
#
#   1. protect + run the program        (reference: clang | opt -TMR | board)
#   2. forced single fault check        (reference: gdb injector setBreaking)
#   3. a seeded fault-injection campaign (reference: supervisor.py + QEMU)
#   4. analysis by the port's log parser (reference: jsonParser.py)
#
# The reference's workflow goes on to the CI gate and a few seconds of
# serving; on the port those are `python -m coast_tpu_torch ci check` and
# `python -m coast_tpu_torch serve`, run on their own.
#
# Usage: sh coast_tpu_torch/scripts/zero_to_aha.sh [-d cpu|cuda]
#            [program.c] [n_injections]
# Every step runs on the card unless given -d cpu.  The default program
# is tests/c_sources/mm9.c; logs go under build/studies/.
set -e
cd "$(dirname "$0")/../.."

DEV=cuda
if [ "$1" = "-d" ]; then
    DEV="$2"
    shift 2
fi
case "$DEV" in
    cuda) BOARD=gpu ;;
    cpu) BOARD=cpu ;;
    *) echo "error: -d takes cpu or cuda, not '$DEV'" >&2; exit 2 ;;
esac
SRC="${1:-tests/c_sources/mm9.c}"
N="${2:-2000}"
mkdir -p build/studies
LOGDIR="$(mktemp -d build/studies/zero_to_aha.XXXXXX)"

echo "== 1. opt -TMR: protect and run the program =="
python3 -c 'import sys
from coast_tpu_torch.opt import main
sys.exit(main(sys.argv[2:], device=sys.argv[1]))' "$DEV" -TMR -countErrors "$SRC"

echo "== 2. forced single fault (supervisor --forceBreak) =="
NAME="$(basename "$SRC" .c)"
FIRST_LEAF=$(python3 - "$SRC" "$DEV" <<'EOF'
import sys

from coast_tpu_torch.models import resolve_region
region = resolve_region(sys.argv[1], device=sys.argv[2])
mem = [n for n, s in region.spec.items() if s.kind == "mem"]
print((mem or sorted(region.spec))[0])
EOF
)
python3 -m coast_tpu_torch.inject.supervisor -f "$SRC" -d "$BOARD" \
    --forceBreak "$FIRST_LEAF:0:0:7:1" --breakCount 1 --no-logging

echo "== 3. $N-injection TMR campaign, reference-container log =="
python3 -m coast_tpu_torch.inject.supervisor -f "$SRC" -t "$N" -d "$BOARD" \
    --log-format reference -l "$LOGDIR"
LOG="$LOGDIR/${NAME}_TMR_memory.json"

# The aha: when running an unannotated mm.c, also campaign its
# __xMR-ANNOTATED variant -- same program, same seeds; the voters change
# the story.
TMR_SRC="$(dirname "$SRC")/${NAME}_tmr.c"
if [ "$NAME" = "mm" ] && [ -f "$TMR_SRC" ]; then
    echo "== 3b. same campaign on the __xMR-annotated variant =="
    python3 -m coast_tpu_torch.inject.supervisor -f "$TMR_SRC" -t "$N" \
        -d "$BOARD" --log-format reference -l "$LOGDIR"
fi

echo "== 4. analysis =="
TMR_LOG="$LOGDIR/${NAME}_tmr_TMR_memory.json"
python3 -m coast_tpu_torch.analysis "$LOG"
if [ -f "$TMR_LOG" ]; then
    python3 -m coast_tpu_torch.analysis "$TMR_LOG"
fi
echo "logs in: $LOGDIR"
