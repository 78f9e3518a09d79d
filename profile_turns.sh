#!/bin/bash
# Where a step's time goes on one card, this tree against another in turns.
#
#   bash profile_turns.sh OTHER_DIR [OUT_DIR]
#
# OTHER_DIR holds the other tree, unpacked inside this checkout (for the
# parent commit: git archive <commit> | tar -x -C build/parent); this
# tree's graal_tpu_torch/profile_paths.py is copied into it first, so both
# print the same rows. Runs `python -m graal_tpu_torch.profile_paths
# --modes graph` (all eleven paths) on other, this, this, other, then
# `chip_smoke.py --top-tiers` on other and this; every output goes to
# OUT_DIR (default build/profile_turns).
set -euo pipefail
other=$1
out=${2:-build/profile_turns}
mkdir -p "$out"
cp graal_tpu_torch/profile_paths.py "$other/graal_tpu_torch/profile_paths.py"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
profile() {
    (cd "$1" && python3 -m graal_tpu_torch.profile_paths --modes graph) > "$out/$2.jsonl" 2> "$out/$2.err"
    echo "$2 done $(date +%T)"
}
profile "$other" other1
profile . this1
profile . this2
profile "$other" other2
(cd "$other" && python3 chip_smoke.py --top-tiers) > "$out/top_other.log" 2>&1
python3 chip_smoke.py --top-tiers > "$out/top_this.log" 2>&1
tail -n 1 "$out/top_other.log" "$out/top_this.log"
