"""Port parity for the distributed graph service
(``pgl_tpu_torch.distributed``): the reference's
``tests/test_dist_cpu_graph.py`` case by case on the port's servers and
clients, and both packages' clusters side by side over the same files.

The port's service samples through its own C++ host kernel
(``native/graph_kernel``) and numpy's ``default_rng`` as the reference's
does, so the same files and seeds give the same samples bit for bit:
uniform (the native partial Fisher–Yates) and weighted (alias tables)
successors and predecessors, random nodes, shuffled node batches, cached
samples, and ``metapath_randomwalk_dist``'s walks. The reference's
eight-server-process test becomes the port's: 8 servers started once for
the module through the port's launcher (one by ``RANK`` instead of
``--server_id``), every wait bounded.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from pgl_tpu.distributed import DistGraphClient as JClient
from pgl_tpu.distributed import DistGraphServer as JServer
from pgl_tpu.distributed import helper as jhelper
from pgl_tpu.sampling import metapath_randomwalk_dist as j_walk_dist
from pgl_tpu_torch.distributed import (DistGraphClient, DistGraphServer,
                                       helper, stream_shuffle_generator)
from pgl_tpu_torch.distributed.helper import (get_all_edge_type,
                                              parse_files, reverse_etype)
from pgl_tpu_torch.distributed.launch import (launch_local_cluster,
                                              server_id_from,
                                              wait_server_ready)
from pgl_tpu_torch.sampling import metapath_randomwalk_dist

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EDGES = """11\t201\t0.50
11\t202\t0.25
11\t203\t0.75
12\t204\t1.10
12\t205\t0.40
12\t206\t0.90
13\t201\t0.30
13\t202\t0.60
13\t207\t0.20
14\t204\t0.80
15\t208\t0.45
16\t208\t0.55
13\t208\t1.30
14\t209\t0.15
"""

NODES = """u\t11
u\t12
u\t13
u\t14
u\t15
u\t16
t\t201
t\t202
t\t203
t\t204
t\t205
t\t206
t\t207
t\t208
t\t209
"""

# the bipartite cluster: users 0..N_U-1, items N_U.., unweighted u2i
N_U, N_I, N_E = 300, 200, 3000


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster(server_cls, client_cls, config, n):
    ips = [f"127.0.0.1:{_free_port()}" for _ in range(n)]
    servers = [server_cls(config, shard_num=4, ip_config=ips, server_id=i)
               for i in range(n)]
    client = client_cls(config, shard_num=4, ip_config=ips, client_id=0)
    client.load_edges()
    client.load_node_types()
    return servers, client


@pytest.fixture(scope="module")
def service(tmp_path_factory):
    """(port clients, reference client, bipartite port client, bipartite
    reference client), each package on servers of its own."""
    d = tmp_path_factory.mktemp("distgraph")
    (d / "edges.txt").write_text(EDGES)
    (d / "node_types.txt").write_text(NODES)
    config = {
        "etype2files": f"u2e2t:{d}/edges.txt",
        "symmetry": True,
        "ntype2files": f"u:{d}/node_types.txt,t:{d}/node_types.txt",
        "nfeat_info": [["u", "a", "float32", 1]],
    }
    rng = np.random.default_rng(5)
    src = rng.integers(0, N_U, N_E)
    dst = N_U + rng.integers(0, N_I, N_E)
    np.savetxt(d / "u2i.txt", np.stack([src, dst], 1), fmt="%d",
               delimiter="\t")
    (d / "bip_nodes.txt").write_text(
        "".join(f"u\t{i}\n" for i in range(N_U))
        + "".join(f"i\t{N_U + i}\n" for i in range(N_I)))
    bip = {"etype2files": f"u2i:{d}/u2i.txt", "symmetry": True,
           "ntype2files": f"u:{d}/bip_nodes.txt,i:{d}/bip_nodes.txt",
           "nfeat_info": [["u", "emb", "float32", 4]]}
    servers, clients = [], []
    ips = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    servers += [DistGraphServer(config, shard_num=4, ip_config=ips,
                                server_id=i) for i in range(2)]
    clients += [DistGraphClient(config, shard_num=4, ip_config=ips,
                                client_id=i) for i in range(2)]
    clients[0].load_edges()
    clients[0].load_node_types()
    jservers, jclient = _cluster(JServer, JClient, config, 2)
    bservers, bclient = _cluster(DistGraphServer, DistGraphClient, bip, 3)
    jbservers, jbclient = _cluster(JServer, JClient, bip, 3)
    yield {"port": clients, "ref": jclient, "bip": bclient,
           "jbip": jbclient, "bip_edges": (src, dst)}
    for c in clients + [jclient, bclient, jbclient]:
        c.stop_server()
    for s in servers + jservers + bservers + jbservers:
        s.stop()


def test_parse_helpers():
    assert parse_files("u2e2t:./e.txt,f2e2t:./f.txt") == {
        "u2e2t": ["./e.txt"], "f2e2t": ["./f.txt"]}
    assert reverse_etype("u2e2t") == "t2e2u"
    assert get_all_edge_type({"u2e2t": []}, True) == ["u2e2t", "t2e2u"]
    # the reference's rule: a two-part type reverses into itself
    assert reverse_etype("u2i") == "u2i"
    assert get_all_edge_type({"u2i": []}, True) == ["u2i"]
    for spec in ("a2b2c:x;y,d:z", "", "u2i:f"):
        assert helper.parse_files(spec) == jhelper.parse_files(spec)
    for e in ("u2i", "u2e2t", "plain", "a2b2c2d"):
        assert helper.parse_etype(e) == jhelper.parse_etype(e)
        assert helper.reverse_etype(e) == jhelper.reverse_etype(e)
    assert helper.load_ip_addr("a:1;b:2") == ["a:1", "b:2"]
    cfg = helper.load_config({"symmetry": True})
    assert cfg.symmetry is True and cfg.missing is None


def test_edge_and_node_types(service):
    c = service["port"][0]
    assert c.get_edge_types() == ["u2e2t", "t2e2u"]
    assert sorted(c.get_node_types()) == ["t", "u"]


def test_sample_successor(service):
    c = service["port"][0]
    out = c.sample_successor([11, 12], max_degree=10, edge_type="u2e2t")
    assert sorted(out[0].tolist()) == [201, 202, 203]
    assert sorted(out[1].tolist()) == [204, 205, 206]
    # bounded fan-out
    out = c.sample_successor([13], max_degree=2, edge_type="u2e2t")
    assert len(out[0]) == 2
    assert set(out[0].tolist()) <= {201, 202, 207, 208}


def test_sample_predecessor_via_reverse(service):
    c = service["port"][1]
    out = c.sample_predecessor([208], max_degree=10, edge_type="u2e2t")
    assert sorted(out[0].tolist()) == [13, 15, 16]


def test_random_sample_nodes(service):
    c = service["port"][0]
    out = c.random_sample_nodes(node_type="u", size=4, seed=0)
    assert len(out) >= 1
    assert set(out.tolist()) <= {11, 12, 13, 14, 15, 16}


def test_node_batch_iter_coverage(service):
    c = service["port"][0]
    seen = []
    for batch in c.node_batch_iter(4, node_type="t", shuffle=True,
                                   shuffle_size=8, seed=1):
        seen.extend(batch.tolist())
    assert sorted(seen) == list(range(201, 210))


def test_node_feat(service):
    c = service["port"][0]
    c.set_node_feat("u", "a", [11, 12], [1.5, 2.5])
    vals = c.get_node_feat([11, 12, 13], "u", "a")
    assert vals[0] == 1.5 and vals[1] == 2.5 and vals[2] is None


def _equal_lists(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("max_degree", [1, 2, 10])
def test_weighted_samples_equal_reference(service, max_degree):
    """The weighted (alias-table) path: the same seeds give the reference's
    samples bit for bit, successors and predecessors."""
    c, j = service["port"][0], service["ref"]
    nodes = [11, 12, 13, 14, 15, 16, 99]
    for seed in (0, 3, 17):
        _equal_lists(c.sample_successor(nodes, max_degree, "u2e2t",
                                        seed=seed),
                     j.sample_successor(nodes, max_degree, "u2e2t",
                                        seed=seed))
        items = [201, 204, 208, 209]
        _equal_lists(c.sample_predecessor(items, max_degree, "u2e2t",
                                          seed=seed),
                     j.sample_predecessor(items, max_degree, "u2e2t",
                                          seed=seed))


@pytest.mark.parametrize("max_degree", [1, 3, 50])
def test_uniform_samples_equal_reference(service, max_degree):
    """The uniform path (the native partial Fisher–Yates over a shard's
    CSR), packed and unpacked, over 3 servers: equal bit for bit."""
    c, j = service["bip"], service["jbip"]
    nodes = np.random.default_rng(1).integers(0, N_U + N_I, 400)
    for seed in (0, 11):
        for packed in (False, True):
            got = c.sample_successor(nodes, max_degree, "u2i", seed=seed,
                                     packed=packed)
            want = j.sample_successor(nodes, max_degree, "u2i", seed=seed,
                                      packed=packed)
            _equal_lists(got, want)
        _equal_lists(c.sample_predecessor(nodes, max_degree, "u2i",
                                          seed=seed),
                     j.sample_predecessor(nodes, max_degree, "u2i",
                                          seed=seed))


def test_sampled_neighbours_are_edges(service):
    src, dst = service["bip_edges"]
    succ = {}
    for s, d in zip(src, dst):
        succ.setdefault(int(s), set()).add(int(d))
    nodes = np.arange(N_U)
    out = service["bip"].sample_successor(nodes, 10000, "u2i", seed=2)
    for n, nb in zip(nodes, out):
        assert set(nb.tolist()) == succ.get(int(n), set())


def test_nodes_and_batches_equal_reference(service):
    c, j = service["bip"], service["jbip"]
    for ntype in ("u", "i", None):
        for seed in (0, 5):
            np.testing.assert_array_equal(
                c.random_sample_nodes(ntype, 64, seed=seed),
                j.random_sample_nodes(ntype, 64, seed=seed))
        for shuffle in (True, False):
            _equal_lists(list(c.node_batch_iter(37, ntype, shuffle=shuffle,
                                                shuffle_size=100, seed=3)),
                         list(j.node_batch_iter(37, ntype, shuffle=shuffle,
                                                shuffle_size=100, seed=3)))
    batches = [np.arange(i, i + 5) for i in range(0, 40, 5)]
    from pgl_tpu.distributed import stream_shuffle_generator as j_shuffle
    _equal_lists(list(stream_shuffle_generator(iter(batches), 5, 12, 4)),
                 list(j_shuffle(iter(batches), 5, 12, 4)))


def test_node_feat_equal_reference(service):
    c, j = service["bip"], service["jbip"]
    feat = np.random.default_rng(3).normal(size=(N_U, 4)).astype(np.float32)
    for client in (c, j):
        client.set_node_feat("u", "emb", np.arange(N_U), list(feat))
    q = np.array([0, 5, N_U - 1, N_U + 3])
    got, want = (cl.get_node_feat(q, "u", "emb") for cl in (c, j))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.stack(got[:3]), feat[q[:3]])


def test_metapath_randomwalk_dist_equal_reference(service):
    """One batched RPC a hop; over the same cluster data and seed the
    walks equal the reference's exactly, and each hop is an edge."""
    c, j = service["bip"], service["jbip"]
    starts = np.arange(N_U)
    for seed in (0, 9):
        got = metapath_randomwalk_dist(c, starts, "u2i-i2u", 9, seed=seed)
        want = j_walk_dist(j, starts, "u2i-i2u", 9, seed=seed)
        np.testing.assert_array_equal(got, want)
    src, dst = service["bip_edges"]
    edges = set(zip(src.tolist(), dst.tolist()))
    for w in got[:50]:
        for a, b in zip(w[:-1], w[1:]):
            if b < 0:
                break
            assert (a, b) in edges or (b, a) in edges


def test_neighbor_sample_lru_cache(service):
    """use_cache=True: first sample fills the LRU from get_neighbors, the
    second is served locally (hit counter), results stay the full neighbor
    set whenever degree <= max_degree (reference
    use_neighbors_sample_cache, pgl/distributed/dist_graph.py:208-456); a
    cached client draws the reference's cached samples bit for bit."""
    base = service["port"][0]
    cached = DistGraphClient(base.config, shard_num=4,
                             ip_config=base.ip_addr, client_id=9,
                             use_cache=True, cache_size=64)
    jbase = service["ref"]
    jcached = JClient(jbase.config, shard_num=4, ip_config=jbase.ip_addr,
                      client_id=9, use_cache=True, cache_size=64)
    try:
        ref = base.sample_successor([11, 12, 13], max_degree=10,
                                    edge_type="u2e2t")
        out1 = cached.sample_successor([11, 12, 13], max_degree=10,
                                       edge_type="u2e2t")
        assert cached.cache_misses == 3 and cached.cache_hits == 0
        out2 = cached.sample_successor([11, 12, 13], max_degree=10,
                                       edge_type="u2e2t")
        assert cached.cache_hits == 3
        for r, a, b in zip(ref, out1, out2):
            np.testing.assert_array_equal(sorted(a), sorted(r))
            np.testing.assert_array_equal(sorted(b), sorted(r))
        # truncated sampling still draws from the true neighbor set
        small = cached.sample_successor([13], max_degree=2,
                                        edge_type="u2e2t")[0]
        assert len(small) == 2
        assert set(small.tolist()) <= {201, 202, 207, 208}
        # the reference's cached client through the same calls
        for args in (([11, 12, 13], 10), ([11, 12, 13], 10), ([13], 2)):
            jcached.sample_successor(*args, edge_type="u2e2t")
        for seed in (0, 4):
            _equal_lists(cached.sample_successor([11, 12, 13, 14], 2,
                                                 "u2e2t", seed=seed),
                         jcached.sample_successor([11, 12, 13, 14], 2,
                                                  "u2e2t", seed=seed))
        assert (cached.cache_hits, cached.cache_misses) == (
            jcached.cache_hits, jcached.cache_misses)
    finally:
        cached._conns = []  # servers shut down by the fixture
        jcached._conns = []


def test_lru_eviction(service):
    base = service["port"][0]
    cached = DistGraphClient(base.config, shard_num=4,
                             ip_config=base.ip_addr, client_id=10,
                             use_cache=True, cache_size=2)
    try:
        cached.sample_successor([11, 12, 13], max_degree=10,
                                edge_type="u2e2t")
        assert len(cached._nbr_cache) == 2  # evicted down to capacity
        cached.sample_successor([13], max_degree=10, edge_type="u2e2t")
        assert cached.cache_hits == 1      # 13 stayed (most recent)
    finally:
        cached._conns = []


def test_predecessor_needs_symmetry(tmp_path):
    (tmp_path / "e.txt").write_text("1\t2\n")
    servers, client, ips = launch_local_cluster(
        {"etype2files": f"a2b:{tmp_path}/e.txt", "symmetry": False}, 1)
    try:
        assert client.get_edge_types() == ["a2b"]
        with pytest.raises(ValueError, match="symmetry"):
            client.sample_predecessor([2], 3, "a2b")
        np.testing.assert_array_equal(
            client.sample_successor([1], 3, "a2b")[0], [2])
    finally:
        client.stop_server()
        for s in servers:
            s.stop()


def test_server_id_from_rank(monkeypatch):
    """The launcher's server id: ``--server_id``, else ``RANK`` (set by
    ``torch.distributed`` launchers), else an error — where the reference
    asks ``jax.process_index()``."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="RANK"):
        server_id_from(None)
    assert server_id_from(3) == 3
    monkeypatch.setenv("RANK", "5")
    assert server_id_from(None) == 5


# -- eight server processes ---------------------------------------------------

N8, E8 = 400, 2000


@pytest.fixture(scope="module")
def eight(tmp_path_factory):
    """8 shard servers as separate processes (``python -m
    pgl_tpu_torch.distributed.launch``), the last one given its id by
    ``RANK``; a client with the data loaded. Killed at the module's end."""
    d = tmp_path_factory.mktemp("eight")
    rng = np.random.default_rng(0)
    src = rng.integers(0, N8, E8)
    dst = rng.integers(0, N8, E8)
    ef = d / "edges.txt"
    np.savetxt(ef, np.stack([src, dst], 1), fmt="%d", delimiter="\t")
    nf = d / "nodes.txt"
    nf.write_text("".join(f"u\t{i}\n" for i in range(N8)))
    cfg = d / "config.yaml"
    cfg.write_text(f'''etype2files: "u2e2u:{ef}"
ntype2files: "u:{nf}"
symmetry: true
nfeat_info: [["u", "emb", "float32", 4]]
''')
    ips = [f"127.0.0.1:{_free_port()}" for _ in range(8)]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    base = [sys.executable, "-m", "pgl_tpu_torch.distributed.launch",
            "--config", str(cfg), "--ip_config", ";".join(ips),
            "--shard_num", "32"]
    procs = [subprocess.Popen(base + ["--server_id", str(i)], env=env,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.STDOUT) for i in range(7)]
    procs.append(subprocess.Popen(base, env=dict(env, RANK="7"),
                                  stdout=subprocess.DEVNULL,
                                  stderr=subprocess.STDOUT))
    try:
        wait_server_ready(ips, timeout=120)
        client = DistGraphClient(str(cfg), shard_num=32, ip_config=ips,
                                 client_id=0)
        client.load_edges()
        client.load_node_types()
        yield client, src, dst, rng
        client.stop_server()
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait(timeout=30)


def test_eight_server_processes(eight):
    """Every query type returns correct, complete results across the full
    shard fan-out of 8 server processes."""
    client, src, dst, rng = eight
    succ = {}
    for s, d in zip(src, dst):
        succ.setdefault(int(s), set()).add(int(d))
        succ.setdefault(int(d), set()).add(int(s))  # symmetry
    nodes = rng.choice(N8, 64, replace=False)
    out = client.sample_successor(nodes, max_degree=10000,
                                  edge_type="u2e2u")
    for n, nb in zip(nodes, out):
        assert set(nb.tolist()) == succ.get(int(n), set()), int(n)
    seen = np.concatenate(list(
        client.node_batch_iter(batch_size=64, node_type="u",
                               shuffle=False)))
    assert sorted(seen.tolist()) == list(range(N8))
    feat = rng.normal(size=(N8, 4)).astype(np.float32)
    client.set_node_feat("u", "emb", np.arange(N8), list(feat))
    got = client.get_node_feat(nodes, "u", "emb")
    np.testing.assert_allclose(np.stack(got), feat[nodes], rtol=1e-6)
