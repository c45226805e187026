#!/bin/bash
# Four cards of one host (one chip call with --chips 4):
#   1. tools/serve_ranks.py: qwen2-vl-72b whole under the serving layout at
#      (1, 4), its 16-layer cut against one card, chatglm3-6b and
#      deepseek-moe-16b in f32 against one card (JSON and log under
#      chiprun_out/);
#   2. deepseek-moe-16b's 28 layers through repro_torch.launch.train at
#      (2, 2), AdamW in place, remat full, 4 steps of 8 x 512 with one
#      checkpoint (169 GB: bf16 parameters and f32 AdamW moments), then the
#      state restored at (1, 4) and gathered back to rank 0's host
#      (tools/ckpt_digest.py) to an equal digest; where the disk holds the
#      state twice, the launcher itself also resumes at (1, 4) and saves it
#      again.  Where the disk holds less than the state, the step says so
#      and is not run.
#
#     bash tools/four_cards.sh            (both)
#     bash tools/four_cards.sh serve      (1 alone; "train": 2 alone)
set -u
part=${1:-all}
cd "$(dirname "$0")/.."
mkdir -p chiprun_out
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0

export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

if [ "$part" != train ]; then
echo "== serve_ranks"
timeout 900 torchrun --standalone --nproc-per-node 4 tools/serve_ranks.py \
    --out chiprun_out/serve_ranks.json > chiprun_out/serve_ranks.log 2>&1
r=$?
grep -a "^serve_ranks:\|Error\|error" chiprun_out/serve_ranks.log | tail -n 5
echo "serve_ranks rc=$r"
[ $r -ne 0 ] && rc=$r
fi
[ "$part" = serve ] && exit $rc

echo "== deepseek-moe-16b launch.train, checkpoint at (2, 2), resume at (1, 4)"
ckpt=${CKPT_DIR:-${TMPDIR:-/tmp}/moe_ckpt}
rm -rf "$ckpt"
mkdir -p "$ckpt"
need=$(python3 -c "
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.tree import tree_leaves
n = sum(x.numel() for x in tree_leaves(lm.abstract_params(
    get_config('deepseek-moe-16b'))))
print(n * (2 + 4 + 4))")
free=$(df --output=avail -B1 "$ckpt" | tail -n 1 | tr -d ' ')
echo "state ${need} bytes, ${free} bytes free under ${ckpt}"
args=(--arch deepseek-moe-16b --devices 4 --remat full --steps 4
      --batch 8 --seq 512 --ckpt-dir "$ckpt" --ckpt-interval 4 --log-every 1)
digest() { python3 -c "import json; print(json.load(open('$ckpt/step_0000000004/manifest.json'))['digest'])"; }
if [ "$free" -lt $(( need * 21 / 20 )) ]; then
    echo "train_ckpt: not run (the disk holds less than the state)"
else
    timeout 660 torchrun --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train "${args[@]}" --model-parallel 2 \
        --metrics-out chiprun_out/train_ckpt_2x2.json \
        > chiprun_out/train_ckpt_2x2.log 2>&1
    r=$?
    tail -n 6 chiprun_out/train_ckpt_2x2.log
    echo "train (2, 2) rc=$r digest $(digest)"
    [ $r -ne 0 ] && rc=$r
    # the state restored at (1, 4) and gathered back to rank 0's host
    timeout 480 torchrun --standalone --nproc-per-node 4 \
        tools/ckpt_digest.py --arch deepseek-moe-16b --ckpt-dir "$ckpt" \
        --step 4 --model-parallel 4 > chiprun_out/ckpt_digest_1x4.log 2>&1
    r=$?
    grep -a '"digest"' chiprun_out/ckpt_digest_1x4.log | tail -n 1
    echo "restore (1, 4) rc=$r"
    [ $r -ne 0 ] && rc=$r
    if [ "$free" -ge $(( need * 21 / 10 )) ]; then
        # the launcher resumed at (1, 4): it saves the state again
        first=$(digest)
        timeout 900 torchrun --standalone --nproc-per-node 4 \
            -m repro_torch.launch.train "${args[@]}" --model-parallel 4 \
            > chiprun_out/train_ckpt_1x4.log 2>&1
        r=$?
        tail -n 3 chiprun_out/train_ckpt_1x4.log
        echo "train (1, 4) rc=$r digest (2, 2) $first (1, 4) $(digest)"
        [ $r -ne 0 ] && rc=$r
        [ "$first" != "$(digest)" ] && echo "train_ckpt: digests differ" \
            && rc=1
    else
        echo "train (1, 4): not run (a second save needs twice the state)"
    fi
fi
rm -rf "$ckpt"
exit $rc
