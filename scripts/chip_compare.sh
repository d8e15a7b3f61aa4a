#!/usr/bin/env bash
# Compares two trees of the port on one card, in one call: chip_smoke.py in
# turns (parent, change, change, parent), then the profiled ALS iteration
# (scripts/profile_als_iteration.py) of each tree.
#
#   scripts/chip_compare.sh PARENT_DIR [OUT_DIR]
#
# PARENT_DIR is the other tree, e.g. `git archive <commit>` unpacked into a
# gitignored directory of this checkout (dist/parent). Logs and profiles go
# to OUT_DIR (default: compare_out/ in this checkout); the lines of each
# run that carry its results are printed.
set -u
parent=$(cd "$1" && pwd)
here=$(cd "$(dirname "$0")/.." && pwd)
mkdir -p "${2:-$here/compare_out}"
out=$(cd "${2:-$here/compare_out}" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0
smoke() {  # tree tag
  (cd "$1" && python3 chip_smoke.py) > "$out/smoke_$2.log" 2>&1
  local r=$?
  [ $r -eq 0 ] || rc=1
  echo "== chip_smoke $2: exit $r"
  grep -E "^\[phase (1|2)\]|s/iter|set-up|ingest|p@10" "$out/smoke_$2.log" | cut -c1-600
}
smoke "$parent" parent1
smoke "$here" change1
smoke "$here" change2
smoke "$parent" parent2
for tag in parent change; do
  root=$parent
  [ $tag = change ] && root=$here
  echo "== profile $tag"
  python3 "$here/scripts/profile_als_iteration.py" --root "$root" \
    --out "$out/profile_$tag.json" || rc=1
done
exit $rc
