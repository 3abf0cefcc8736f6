#!/usr/bin/env bash
# Canonical test-suite invocations on the CPU (see CLAUDE.md "Commands").
#
# Usage:
#   scripts/run_suite.sh fast    # CPU 8-device mesh, -m "not slow"
#   scripts/run_suite.sh slow    # the long integration runs
#   scripts/run_suite.sh all     # fast + slow
set -u
cd "$(dirname "$0")/.."

run_fast() {
  timeout 1200 python -m pytest tests/ -q -m "not slow" -n 6
}

run_slow() {
  timeout 3600 python -m pytest tests/ -q -m slow -n 6
}

case "${1:-fast}" in
  fast) run_fast ;;
  slow) run_slow ;;
  all)  run_fast && run_slow ;;
  *) echo "usage: $0 {fast|slow|all}" >&2; exit 2 ;;
esac
