#!/bin/sh
# One-command verification: full test suite (8 virtual CPU devices),
# the multi-device dryrun, and (with RUN_BENCH=1) the bench.
set -e
cd "$(dirname "$0")/.."
python -m pytest tests/ -q
python -c "from __graft_entry__ import dryrun_multichip; dryrun_multichip(8)"
# RUN_GATES=1 adds the real-data behavioural gates (slow; the
# SHA-pinned CSVs + oracle corroborations)
if [ "${RUN_GATES:-0}" = "1" ]; then
    python -m pytest -m realdata tests/test_realdata.py -q
fi
if [ "${RUN_BENCH:-0}" = "1" ]; then python bench.py; fi
echo "check.sh: all green"
