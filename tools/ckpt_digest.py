#!/usr/bin/env python3
"""A training checkpoint restored on another mesh, its digest recomputed.

    torchrun --standalone --nproc-per-node 4 tools/ckpt_digest.py \\
        --arch deepseek-moe-16b --ckpt-dir DIR --step 4 --model-parallel 4

Every rank restores checkpoint ``--step`` of ``repro_torch.launch.train``
(its parameters and optimizer state, in the reference's layout) onto the
(data, model) mesh of the ranks at ``--model-parallel``
(``elastic.restore_on_mesh``), gathers it back (``ckpt.gather_to_host``:
rank 0 alone keeps the host copies) and rank 0 hashes it as ``ckpt.save``
does: the resumed state's digest, without writing the state a second time
(a 28-layer deepseek-moe-16b state is 169 GB).  Rank 0 prints the digest
beside the manifest's and exits non-zero if they differ.  ``--device cpu``
joins gloo; ``--reduced`` takes the reduced config (as ``launch.train
--reduced`` wrote it).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--step", type=int, required=True)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--device", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_to_reference
    from repro_torch.distributed.elastic import restore_on_mesh
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.models import lm
    from repro_torch.train.optimizers import get_optimizer

    args = parse_args(argv)
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            **({"device_id": device}
                               if device.type == "cuda" else {}))
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        mesh = make_mesh_for(dist.get_world_size(), args.model_parallel,
                             device_type=device.type)
        abstract = lm_params_to_reference(lm.abstract_params(cfg), cfg)
        like = {"params": abstract,
                "opt": get_optimizer(args.optimizer, 1e-4).init(abstract)}
        tree, _ = restore_on_mesh(args.ckpt_dir, args.step, like, mesh,
                                  device)
        host = ckpt.gather_to_host(tree, param_shardings(like, mesh), mesh)
        del tree
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, len(host))
        if dist.get_rank() != 0:
            return 0
        h = hashlib.sha256()
        for name in sorted(host):
            h.update(name.encode())
            h.update(host[name].tobytes()[:4096])
        path = os.path.join(args.ckpt_dir, f"step_{args.step:010d}",
                            "manifest.json")
        with open(path) as f:
            want = json.load(f)["digest"]
        print(json.dumps({"mesh": list(mesh.mesh.shape),
                          "host_leaves_by_rank": counts,
                          "digest": h.hexdigest(), "manifest_digest": want,
                          "equal": h.hexdigest() == want}), flush=True)
        return 0 if h.hexdigest() == want else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
