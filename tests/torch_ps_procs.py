"""Processes of the port's parameter-server test
(``tests/test_torch_ps.py``), each importing torch and the port only:

    python tests/torch_ps_procs.py shard SHARD NUM_SHARDS
        serves ``EmbeddingShardService(SHARD, NUM_SHARDS)`` on a free
        loopback port, prints ``PORT <port>`` and serves until killed;
    python tests/torch_ps_procs.py trainer RANK ADDRS OUT
        trains the ``deepwalk`` Graph4Rec preset (small widths, on the
        CPU, one torch thread) against the shards at ADDRS (``;``-joined)
        for ``EPOCHS`` epochs, writes its per-epoch losses to OUT (json)
        and prints ``TRAINER<RANK> PASS``.

:func:`start_shards` and :func:`run_trainers` launch them for the test,
every wait bounded.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
GRAPH = dict(num_nodes=300, num_groups=6, avg_degree=8, seed=0)
DIM = 16


def trainer_config():
    return dict(embed_dim=DIM, walk_len=10, win_size=3, batch_pairs=512,
                walks_per_node=1, lr=0.05)


def _env():
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def start_shards(num_shards: int, timeout: float = 60.0):
    """(processes, addresses) of ``num_shards`` shard servers."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "shard", str(s),
         str(num_shards)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env())
        for s in range(num_shards)]
    addrs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            line = ""
            while not line.startswith("PORT "):
                if time.time() > deadline or p.poll() is not None:
                    raise TimeoutError(f"shard server not up: {line!r}")
                line = p.stdout.readline()
            addrs.append(f"127.0.0.1:{int(line.split()[1])}")
    except BaseException:
        stop(procs)
        raise
    return procs, addrs


def run_trainers(num: int, addrs, out_dir, timeout: float = 240.0):
    """Run ``num`` trainer processes to their end; their losses by rank."""
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "trainer", str(r),
         ";".join(addrs), os.path.join(out_dir, f"trainer{r}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(num)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        stop(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"TRAINER{r} PASS" not in out:
            raise AssertionError(f"trainer {r} failed:\n{out[-4000:]}")
    return [json.load(open(os.path.join(out_dir, f"trainer{r}.json")))
            for r in range(num)]


def stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=30)
        if p.stdout is not None:
            p.stdout.close()


def main():
    import torch
    torch.set_num_threads(1)
    mode = sys.argv[1]
    if mode == "shard":
        from pgl_tpu_torch.distributed.ps import start_shard_server
        srv = start_shard_server(int(sys.argv[2]), int(sys.argv[3]))
        print(f"PORT {srv.port}", flush=True)
        while True:
            time.sleep(3600)
    rank, addrs, out = int(sys.argv[2]), sys.argv[3].split(";"), sys.argv[4]
    from pgl_tpu_torch.apps.graph4rec import Graph4RecTrainer
    from pgl_tpu_torch.datasets import blogcatalog_shaped_graph
    g, _ = blogcatalog_shaped_graph(**GRAPH)
    tr = Graph4RecTrainer.from_preset(
        "deepwalk", graph=g, seed=rank, ps_addresses=addrs, device="cpu",
        **trainer_config())
    losses = []
    for epoch in range(EPOCHS):
        steps = [float(tr.step(*batch)) for batch in tr.batches(epoch)]
        losses.append(sum(steps) / len(steps))
    for table in tr.ps.values():
        table.flush()
        table.close()
    with open(out, "w") as f:
        json.dump(losses, f)
    print(f"TRAINER{rank} PASS", flush=True)


if __name__ == "__main__":
    main()
