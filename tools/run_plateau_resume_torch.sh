#!/bin/bash
# The plateau + kill->resume exercise of tools/run_plateau_resume.sh, on the
# PyTorch port: vfidkr_torch.apps.train on a synthetic-motion Vimeo-layout
# set written by vfidkr_torch.data.synthetic (18 triplets: 12 train / 6
# test, so batch-3 validation forms 2 batches), at the reference LR with
# patience 1 and factor 0.2.  Phase A is SIGKILLed as soon as log.txt holds
# >= KILL_AFTER epoch rows; phase B --resume restores the full train state
# (weights, Adamax moments, plateau scale / best / bad epochs, best
# validation loss) from the last epoch checkpoint and runs to the end.  The
# checker asserts (a) a contiguous epoch seam across the kill, (b) at
# least one learning-rate step below 1.0 and (c) that no decode worker of
# phase A outlived it.
#
# Usage: tools/run_plateau_resume_torch.sh [save_dir] [--device cpu]
#   (default save dir build/run_plateau_torch, default device cuda)
set -u
SAVE=${1:-build/run_plateau_torch}
DEVICE=${2:-cuda}
KILL_AFTER=${KILL_AFTER:-3}
cd "$(dirname "$0")/.."
DATA=$SAVE.data

[ -d "$DATA/sequences" ] || \
    python -m vfidkr_torch.data.synthetic --out "$DATA" --n 18 --test-frac 0.34
rm -rf "$SAVE"

ARGS=(--dataset-path "$DATA" --save-path "$SAVE" --batch-size 3
      --num-epochs 24 --steps-per-epoch 40 --val-batches 2
      --patience 1 --factor 0.2 --device "$DEVICE")

echo "== phase A (SIGKILLed after $KILL_AFTER logged epochs) =="
T0=$(date +%s)
python -m vfidkr_torch.apps.train "${ARGS[@]}" & PID=$!
for i in $(seq 1 1800); do
    sleep 1
    kill -0 "$PID" 2>/dev/null || break
    n=$(wc -l < "$SAVE/log.txt" 2>/dev/null || echo 0)
    if [ "$n" -ge "$KILL_AFTER" ]; then
        echo "log has $n rows -> SIGKILL $PID"
        kill -9 "$PID"
        break
    fi
done
wait "$PID" 2>/dev/null
echo "phase A exit: $? (137 = SIGKILL, expected) after $(( $(date +%s) - T0 )) s"
sleep 2
# the trainer's decode workers (forked, so the same command line) must die
# with it
LEFT=$(python - "$SAVE" <<'PYEOF'
import os, sys
n = 0
for pid in filter(str.isdigit, os.listdir("/proc")):
    try:
        args = open(f"/proc/{pid}/cmdline", "rb").read().split(b"\0")
    except OSError:
        continue
    n += b"vfidkr_torch.apps.train" in args and sys.argv[1].encode() in args
print(n)
PYEOF
)
echo "trainer processes left after the SIGKILL: $LEFT"
echo "log after phase A:"; cat "$SAVE/log.txt"

echo "== phase B (--resume) =="
T1=$(date +%s)
timeout 1500 python -m vfidkr_torch.apps.train "${ARGS[@]}" --resume
echo "phase B exit: $? after $(( $(date +%s) - T1 )) s"
echo "final log:"; cat "$SAVE/log.txt"

python - "$SAVE" "$LEFT" <<'PYEOF'
import sys, numpy as np
assert sys.argv[2] == "0", f"{sys.argv[2]} processes outlived the SIGKILL"
rows = np.loadtxt(sys.argv[1] + "/log.txt", delimiter=",", ndmin=2)
epochs = rows[:, 0].astype(int)
assert (np.diff(epochs) == 1).all(), f"epoch seam broken: {epochs}"
scales = rows[:, 1]
assert scales.min() < 1.0, "no plateau reduction triggered"
first_red = int(epochs[np.argmax(scales < 1.0)])
print(f"OK: epochs {epochs[0]}..{epochs[-1]} contiguous across the kill; "
      f"first LR reduction at epoch {first_red} "
      f"(scale {scales.min():.3f}); final val loss {rows[-1, 3]:.4f}")
PYEOF
