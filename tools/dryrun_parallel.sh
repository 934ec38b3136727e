#!/bin/bash
# Every cell of `python -m repro_torch.launch.dryrun --all --mesh both`, one
# process per cell (each its own fake process group), JOBS at a time.
#
#   tools/dryrun_parallel.sh OUT_DIR [JOBS] [extra dryrun flags...]
#
# Each cell's report lands in OUT_DIR/<mesh>/<arch>__<shape>.json and its
# console in OUT_DIR/logs/<mesh>__<arch>__<shape>.log, a failed cell's
# traceback in OUT_DIR/failures.log; OUT_DIR/summary.txt holds every
# cell's [ok]/[FAIL] line and its wall seconds, and the card's name and
# power limit when nvidia-smi finds one.  Exits 1 if any cell failed.
# CELLS, if set, is a grep pattern over the "<mesh> <arch> <shape>" lines
# that picks the cells to run (e.g. CELLS='^multi .* train_4k$');
# CELL_TIMEOUT, if set, the seconds a cell may take.
set -u
out=${1:?usage: tools/dryrun_parallel.sh OUT_DIR [JOBS] [flags...]}
jobs=${2:-8}
shift $(( $# < 2 ? $# : 2 ))
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
mkdir -p "$out/logs"
python - > "$out/cells.txt" <<'PY'
from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import ARCHS
for mesh in ("single", "multi"):
    for name, cfg in ARCHS.items():
        for shape in shapes_for(cfg):
            print(mesh, name, shape.name)
PY
if [ -n "${CELLS:-}" ]; then
    grep -E "$CELLS" "$out/cells.txt" > "$out/cells.sel"
    mv "$out/cells.sel" "$out/cells.txt"
fi
cell() {
    local mesh=$1 arch=$2 shape=$3
    local log="$OUT/logs/${mesh}__${arch}__${shape}.log" start=$SECONDS
    # shellcheck disable=SC2086
    timeout "${CELL_TIMEOUT:-0}" python -m repro_torch.launch.dryrun --arch "$arch" --shape "$shape" \
        --mesh "$mesh" --out "$OUT" --force $EXTRA > "$log" 2>&1
    local rc=$?
    local line
    line=$(grep -E '^\[(ok|FAIL)\]' "$log" | tail -1)
    echo "${line:-[FAIL] $mesh $arch $shape: no report (rc $rc)} wall=$((SECONDS - start))s"
}
export -f cell
export OUT="$out" EXTRA="$*"
xargs -P "$jobs" -L 1 bash -c 'cell "$@"' _ < "$out/cells.txt" \
    | tee "$out/summary.txt"
if command -v nvidia-smi > /dev/null; then
    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
        | tee -a "$out/summary.txt"
fi
! grep -q '^\[FAIL\]' "$out/summary.txt"
