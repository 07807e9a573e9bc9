"""Launcher: ``python -m elasticsearch_tpu_torch.server``, ES's
``bin/elasticsearch``.

Port of elasticsearch_tpu/server.py (reference: ES's
bootstrap/Bootstrap.java and bin/elasticsearch). It builds one ``Node`` on
``--device``: ``cuda`` (every visible card, the default), ``cuda:N``, a
comma list (``cuda:0,cuda:1``; the shards spread over them) or ``cpu``
when the caller asks; there is no fallback to the CPU. It serves it
over HTTP with ``rest/server.py``, prints ``listening on
http://host:port (device ...)`` once the socket is bound (``--port 0``
takes a free port), and on SIGTERM or SIGINT closes the node (the
translog's last sync, the gateway's metadata) and exits 0.

With ``--coordinator host:port`` the process is one member of a
cluster of ``--num-processes``: it joins the members' process group
(``torch.distributed``'s gloo backend over ``tcp://host:port``,
``cluster/bootstrap.py::initialize_distributed``), then its transport:
``--process-id 0`` binds ``--transport-port`` and bootstraps as the
first master, the others bind a free port and join through the
coordinator's host on ``--transport-port``. ``--minimum-master-nodes``
sets the election and publish quorum (by default a majority of the
master-eligible members). Several members may share one card: each is a
process with its own CUDA context.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(prog="elasticsearch_tpu_torch")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--name", default="node-1")
    ap.add_argument("--cluster-name", default="elasticsearch_tpu")
    ap.add_argument("--data-path", default=None,
                    help="directory for translog durability and the "
                         "gateway (indices reopen from it at start)")
    ap.add_argument("--device", default="cuda",
                    help="the devices the node's shards live on: cuda "
                         "(default: every visible card), cuda:N, a comma "
                         "list such as cuda:0,cuda:1, or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's rendezvous; makes this "
                         "process a cluster member")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--transport-port", type=int, default=9300,
                    help="the cluster transport's TCP port (process 0 "
                         "binds it; the others dial the coordinator's "
                         "host on it)")
    ap.add_argument("--minimum-master-nodes", type=int, default=None,
                    help="election and publish quorum; default: a "
                         "majority of the master-eligible members")
    args = ap.parse_args(argv)

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer

    if args.coordinator:
        from elasticsearch_tpu_torch.cluster.bootstrap import \
            initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes,
                               args.process_id)
    node = Node(name=args.name, data_path=args.data_path,
                device=args.device, cluster_name=args.cluster_name)
    cluster = None
    if args.coordinator:
        from elasticsearch_tpu_torch.cluster.bootstrap import \
            MultiHostCluster

        cluster = MultiHostCluster(
            node, args.process_id, args.num_processes,
            bind_host=args.host, transport_port=args.transport_port,
            master_host=args.coordinator.rsplit(":", 1)[0],
            minimum_master_nodes=args.minimum_master_nodes)
        role = "master" if cluster.is_master else "data"
        print(f"[{args.name}] joined cluster as {role} "
              f"(rank {args.process_id}/{args.num_processes}, "
              f"transport {cluster.local.transport_address})", flush=True)
    server = RestServer(node, host=args.host, port=args.port)
    print(f"[{args.name}] listening on http://{server.host}:{server.port} "
          f"(device {','.join(map(str, node.devices))})", flush=True)

    def _stop(*_):
        print("shutting down", flush=True)
        if cluster is not None:
            cluster.close()
        # close the node in the handler and stop the listener from a
        # helper thread: this handler interrupted serve_forever on this
        # thread, so a same-thread httpd.shutdown() would wait forever
        # for the loop it suspended
        threading.Thread(target=server.stop, daemon=True).start()
        node.close()
        sys.exit(0)

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    server.start(background=False)


if __name__ == "__main__":
    main()
