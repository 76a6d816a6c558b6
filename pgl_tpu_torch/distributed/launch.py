"""Graph-service launcher (port of ``pgl_tpu/distributed/launch.py``;
reference: ``pgl/distributed/launch.py``).

The reference bootstraps server addresses over MPI (``:28-57``) and starts
one brpc server per machine (``:70-129``). Here the launcher takes this
host's server id from ``--server_id``, or else from the ``RANK`` variable
that ``torch.distributed`` launchers (``torchrun``) set; a local mode
spins all servers in one process for tests and development.

Usage:
  python -m pgl_tpu_torch.distributed.launch --config graph.yaml \
      --ip_config ips.txt --server_id 0 [--load_data]
  python -m pgl_tpu_torch.distributed.launch --config graph.yaml --local 2

A dict config (``launch_graph_service(config_dict, ...)``, e.g. as a
``multiprocessing`` target) needs no PyYAML.
"""

from __future__ import annotations

import argparse
import os
import socket
import time
from typing import List, Optional

from . import helper
from .dist_graph import DistGraphClient, DistGraphServer
from ..utils.logger import log

__all__ = ["launch_graph_service", "launch_local_cluster",
           "wait_server_ready", "server_id_from"]


def wait_server_ready(addresses: List[str], timeout: float = 120.0):
    """Block until every ``ip:port`` accepts connections
    (reference ``launch.py:61``)."""
    deadline = time.time() + timeout
    for addr in addresses:
        host, port = addr.rsplit(":", 1)
        while True:
            try:
                with socket.create_connection((host, int(port)),
                                              timeout=2.0):
                    break
            except OSError:
                if time.time() > deadline:
                    raise TimeoutError(f"server {addr} not ready")
                time.sleep(0.5)


def launch_graph_service(config, ip_config, server_id: int,
                         shard_num: int = 100, load_data: bool = False,
                         block: bool = False) -> DistGraphServer:
    """Start this host's shard server; optionally (server 0) load the data
    files through a client once all servers are up
    (reference ``launch.py:60-67``)."""
    server = DistGraphServer(config, shard_num, ip_config, server_id)
    addrs = helper.load_ip_addr(ip_config)
    if load_data and server_id == 0:
        wait_server_ready(addrs)
        client = DistGraphClient(config, shard_num, ip_config, client_id=0)
        client.load_edges()
        client.load_node_types()
        client.stop_server()
        log.info("graph data loaded into %d servers", len(addrs))
    if block:
        while True:
            time.sleep(3600)
    return server


def launch_local_cluster(config, num_servers: int = 2,
                         shard_num: int = 100, base_port: int = 0):
    """Dev/test helper: all servers in-process on localhost; returns
    ``(servers, client, ip_list)`` with data loaded."""

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    ips = [f"127.0.0.1:{base_port + i if base_port else free_port()}"
           for i in range(num_servers)]
    servers = [DistGraphServer(config, shard_num, ips, i)
               for i in range(num_servers)]
    wait_server_ready(ips)
    client = DistGraphClient(config, shard_num, ips, client_id=0)
    client.load_edges()
    client.load_node_types()
    return servers, client, ips


def server_id_from(server_id: Optional[int] = None) -> int:
    """``server_id`` when given, else the ``RANK`` environment variable of a
    ``torch.distributed`` launcher; raises when there is neither."""
    if server_id is not None:
        return int(server_id)
    rank = os.environ.get("RANK")
    if rank is None:
        raise ValueError("no server id: pass --server_id, or launch under "
                         "torchrun, which sets RANK")
    return int(rank)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--ip_config", default=None)
    parser.add_argument("--server_id", type=int, default=None)
    parser.add_argument("--shard_num", type=int, default=100)
    parser.add_argument("--load_data", action="store_true")
    parser.add_argument("--local", type=int, default=0,
                        help="run N servers locally and block")
    args = parser.parse_args()

    if args.local:
        servers, client, ips = launch_local_cluster(
            args.config, args.local, args.shard_num)
        log.info("local cluster up at %s", ";".join(ips))
        while True:
            time.sleep(3600)

    server_id = server_id_from(args.server_id)
    launch_graph_service(args.config, args.ip_config, server_id,
                         args.shard_num, load_data=args.load_data,
                         block=True)


if __name__ == "__main__":
    main()
