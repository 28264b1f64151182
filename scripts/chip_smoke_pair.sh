#!/bin/bash
# Compare two versions of the port on one card: run the full chip_smoke.py of
# the parent and of this checkout in turns (parent, change, change, parent) and
# print each run's reconstruct, flash_attention and train-step times, the backward
# kernels' times, the profile summaries and the trainer's times.
# The full outputs go to build/pair/.
#
# Before the run, unpack the parent commit into build/parent (ignored by git):
#     rm -rf build/parent && mkdir -p build/parent && git archive <parent> | tar -x -C build/parent
# then, on the machine with the card, from the root of this checkout:
#     bash scripts/chip_smoke_pair.sh
set -u
mkdir -p build/pair
i=0
for side in parent change change parent; do
  i=$((i + 1))
  if [ "$side" = parent ]; then dir=build/parent; else dir=.; fi
  (cd "$dir" && python3 chip_smoke.py) > "build/pair/$i-$side.txt" 2>&1
  echo "$i $side rc=$?"
  grep -h "time reconstruct\|time flash_attention\|wall time\|profile reconstruct\|time train step\|time conv3x3_dx\|time group_norm_backward\|profile train step\|trainer fit:\|trainer save\|time trainer" "build/pair/$i-$side.txt"
done
