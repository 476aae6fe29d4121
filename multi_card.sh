#!/bin/bash
# The multi-GPU path on four cards: the 128-swarm glob of standin.write_complex
# files (1ppe-shaped DFIRE, 200 glowworms) through the command line for 100
# steps in one process (one card) and under torchrun (four ranks, NCCL), in
# turns (one, four, four, one); prints each run's segment rates from rank 0's
# --metrics and whether the gso text matches.  Run from the repository root
# on a machine with four cards:  bash multi_card.sh
REPO=$(pwd)
export PYTHONPATH=$REPO
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
W=$(mktemp -d); trap 'rm -rf "$W"' EXIT; cd $W
python -c "from lightdock_tpu_torch import standin; standin.write_complex('.', 'dfire', 1615, 221, 200, n_swarms=128, seed=324324)"
G='../initial_positions_*.dat'
for run in one_a four_a four_b one_b; do
  mkdir $run; cd $run
  if [[ $run == one* ]]; then
    python -m lightdock_tpu_torch.cli ../setup.json "$G" 100 dfire --metrics m.jsonl 2>&1 | grep -E "Done"
  else
    python -m torch.distributed.run --nproc-per-node 4 -m lightdock_tpu_torch.cli ../setup.json "$G" 100 dfire --metrics m.jsonl 2>&1 | grep -E "Done"
  fi
  echo "$run exit ${PIPESTATUS[0]}"
  python -c "
import json, statistics
ev = [json.loads(x) for x in open('m.jsonl')]
seg = [e['poses_per_s'] for e in ev if e['event'] == 'segment']
print('$run segments poses/s', seg, 'median 2-10', statistics.median(seg[1:]), 'summary', ev[-1]['poses_per_s'], ev[-1]['total_seconds'])"
  cd ..
done
diff -r -q one_a four_a --exclude=m.jsonl --exclude='*.npz' && echo "gso text one_a == four_a: IDENTICAL"
