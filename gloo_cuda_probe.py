#!/usr/bin/env python3
"""Which gloo exchanges take CUDA tensors on this machine's PyTorch.

    python3 gloo_cuda_probe.py

Runs each exchange the pencil mesh uses (all_reduce, a 0-d all_reduce,
all_to_all_single, all_gather, broadcast, batch_isend_irecv) on float64
CUDA tensors in a pair of gloo processes of its own (an exchange gloo
cannot take on CUDA aborts the process, so each gets fresh ones) and
prints, per exchange, what rank 0 received and both exit codes.
``GLOO_CUDA_STAGED`` in ``spectral_tpu_torch/parallel/mesh.py`` lists the
ones that fail.  Needs a CUDA device.
"""

import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "all_reduce_0d", "all_to_all_single", "all_gather", "broadcast",
       "batch_isend_irecv")


def work(rank: int, store: str, op: str, queue) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
    dev = torch.device("cuda")
    a = torch.arange(4, device=dev, dtype=torch.float64) + 10 * rank
    if op == "all_reduce":
        dist.all_reduce(a)
        out = a
    elif op == "all_reduce_0d":
        out = torch.ones((), device=dev, dtype=torch.float64)
        dist.all_reduce(out)
    elif op == "all_to_all_single":
        out = torch.empty_like(a)
        dist.all_to_all_single(out, a)
    elif op == "all_gather":
        outs = [torch.empty_like(a) for _ in range(2)]
        dist.all_gather(outs, a)
        out = torch.cat(outs)
    elif op == "broadcast":
        dist.broadcast(a, 0)
        out = a
    else:
        out = torch.empty_like(a)
        ops = [dist.P2POp(dist.isend, a, 1 - rank), dist.P2POp(dist.irecv, out, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    torch.cuda.synchronize()
    if rank == 0:
        queue.put(out.cpu().tolist())
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe.py needs a CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    ctx = mp.get_context("spawn")
    for op in OPS:
        queue = ctx.Queue()
        store = os.path.join(tempfile.mkdtemp(), "store")
        procs = [ctx.Process(target=work, args=(r, store, op, queue)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            got = queue.get(timeout=60)
        except Exception as e:   # the exchange aborted a process: no result
            got = f"no result ({type(e).__name__})"
        for p in procs:
            p.join(timeout=20)
            if p.is_alive():
                p.kill()
                p.join()
        print(op, json.dumps({"result": got, "exitcodes": [p.exitcode for p in procs]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
