"""Launcher: ``python -m elasticsearch_tpu_torch.server``, ES's
``bin/elasticsearch``.

Port of elasticsearch_tpu/server.py (reference: ES's
bootstrap/Bootstrap.java and bin/elasticsearch). It builds one ``Node`` on
``--device`` (``cuda`` unless the caller asks for ``cpu``; there is no
fallback to the CPU), serves it over HTTP with ``rest/server.py``, prints
``listening on http://host:port`` once the socket is bound (``--port 0``
takes a free port), and on SIGTERM or SIGINT closes the node (the
translog's last sync, the gateway's metadata) and exits 0.

The reference's multi-host flags (``--coordinator``, ``--num-processes``,
``--process-id``, ``--transport-port``, ``--minimum-master-nodes``) are
refused: the multi-node cluster layer comes with ROADMAP A10f.
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading

#: the reference's multi-host flags, refused until ROADMAP A10f
_MULTI_HOST_FLAGS = ("--coordinator", "--num-processes", "--process-id",
                     "--transport-port", "--minimum-master-nodes")


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
                    help="the device the node's indices live on: cuda "
                         "(default) or cpu")
    for flag in _MULTI_HOST_FLAGS:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in _MULTI_HOST_FLAGS
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if given:
        ap.error(f"{', '.join(given)}: the multi-node cluster layer is not "
                 f"yet in the PyTorch port (ROADMAP A10f)")

    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer

    node = Node(name=args.name, data_path=args.data_path,
                device=args.device, cluster_name=args.cluster_name)
    server = RestServer(node, host=args.host, port=args.port)
    print(f"[{args.name}] listening on http://{server.host}:{server.port} "
          f"(device {node.device})", flush=True)

    def _stop(*_):
        print("shutting down", flush=True)
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
