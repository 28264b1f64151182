#!/bin/bash
# Compare two versions of the port on one card: run the full chip_smoke.py of
# the parent and of the change in turns (parent, change, change, parent, or the
# order given as the second argument) and
# print each run's reconstruct, flash_attention and train-step times, the backward
# kernels' times, the profile summaries and the trainer's times, then a summary
# of each run's train step (ms/step), reconstruct (ms/call) and
# group_norm_backward (ms at each timed shape, and its kernels' ms in the
# profiled step), and the pixel SR and flow-refine steps (ms/step) and the
# attention backward's times. The full outputs go to build/pair/.
#
# Before the run, unpack the parent commit into build/parent (ignored by git):
#     rm -rf build/parent && mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
# then, on the machine with the card, from the root of this checkout:
#     bash scripts/chip_smoke_pair.sh [change directory, default: this checkout] [order]
# e.g. `bash scripts/chip_smoke_pair.sh build/final "change parent"`.
set -u
change=${1:-.}
order=${2:-parent change change parent}
mkdir -p build/pair
i=0
for side in $order; do
  i=$((i + 1))
  if [ "$side" = parent ]; then dir=build/parent; else dir=$change; fi
  (cd "$dir" && python3 chip_smoke.py) > "build/pair/$i-$side.txt" 2>&1
  echo "$i $side rc=$?"
  grep -h "time reconstruct\|time flash_attention\|time pixel SR\|time flow-refine\|wall time\|profile reconstruct\|time train step\|time conv3x3_dx\|time group_norm_backward\|profile train step\|group_norm_backward kernels\|trainer fit:\|trainer save\|time trainer" "build/pair/$i-$side.txt"
done
echo "summary: run side | train step ms/step | reconstruct ms/call (256² B=16, 512² B=4) | group_norm_backward ms (timed shapes) | gn_bwd_ kernels in the profiled step | flow-refine, pixel SR (B = 4, 8) ms/step"
i=0
for side in $order; do
  i=$((i + 1))
  f="build/pair/$i-$side.txt"
  step=$(sed -n 's/^time train step .*: \([0-9.]*\) ms\/step.*/\1/p' "$f" | tr '\n' ' ')
  recon=$(sed -n 's/^time reconstruct .*: \([0-9.]*\) ms\/call.*/\1/p' "$f" | tr '\n' ' ')
  gnb=$(sed -n 's/^time group_norm_backward+swish \(\[[0-9, ]*\]\) bf16: kernel \([0-9.]*\) ms.*/\1 \2/p' "$f" | tr '\n' ' ')
  prof=$(sed -n 's/^  group_norm_backward kernels: \(.*\), .*% of kernel time/\1/p' "$f" | tail -n 1)
  sr=$(sed -n 's/^time \(flow-refine\|pixel SR train\) step .*: \([0-9.]*\) ms\/step.*/\2/p' "$f" | tr '\n' ' ')
  echo "$i $side | $step | $recon | $gnb | $prof | $sr"
done
