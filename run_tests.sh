#!/bin/bash
# Run the test suite on the CPU with an 8-device virtual mesh.
#
# The suite runs as THREE sequential pytest invocations (each with 2 xdist
# workers grouped by file).  XLA:CPU sporadically SEGFAULTS in
# backend_compile_and_load after hundreds of compiles in one process
# (NOTES.md round 3); worse, pytest-xdist's loadscope scheduler can wedge
# after replacing a crashed worker.  Fresh processes per chunk bound the
# per-process compile count below the crash regime and bound the blast
# radius if one still dies.
#
# Usage: ./run_tests.sh [extra pytest args]   # e.g. -m "not slow" for the
#                                             # quick tier (~5 min)
cd "$(dirname "$0")"
ENV="env JAX_PLATFORMS=cpu"
FLAGS="--xla_force_host_platform_device_count=8"
rc=0
for chunk in 'tests/test_[a-i]*.py' 'tests/test_[j-q]*.py' \
             'tests/test_[r-z]*.py'; do
  files=$(ls $chunk 2>/dev/null)
  [ -z "$files" ] && continue
  $ENV PYTHONPATH="$(pwd)" XLA_FLAGS="$FLAGS" \
    python -m pytest $files -q -n 2 --dist loadfile \
    --max-worker-restart 2 "$@" || rc=1
done
exit $rc
