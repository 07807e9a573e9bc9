"""Alternating A/B of phase 5e's B1 arms on one card, two checkouts.

Each argument is a checkout of the repository (for example a parent
unpacked with ``git archive`` into an ignored directory, and ``.``). One
process a checkout builds phase 5's index (``chip_smoke.py``'s 2^20-doc
corpus from its seed, one segment) and 5e(a)'s 1,024 pure-dense bodies,
then waits for its turn. The arms, each timed on the host's clock:

- ``msearch``: 5e(a), one ``Node.msearch`` of the 1,024 bodies (B1's
  batched form, one launch);
- ``coalesced``: 5e(e), the bodies as single ``Node.search`` calls from 64
  threads through the coalescer (adaptive, its default: B1's batched form
  a flush);
- ``off``: the same with the coalescer off (B1's rows form a search).

After two warm rounds of each arm in each process, pair n runs every arm
on A then B for even n and on B then A for odd n, so that drift on the
host falls on both alike.

    python tools/torch_ab_5e.py PARENT . [--pairs 10]

Prints the card's name and power limit, for each checkout and arm the
times, their median, quartiles and q/s, and the pairs the second
checkout won.
"""
from __future__ import annotations

import statistics
import subprocess
import sys

ARMS = ("msearch", "coalesced", "off")

WORKER = r"""
import copy, itertools, os, sys, threading, time
out, sys.stdout = sys.stdout, sys.stderr  # stdout carries the turns only
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from elasticsearch_tpu_torch import Node
from elasticsearch_tpu_torch.index.convert import segment_from_arrays

dev = torch.device("cuda", 0)
corpus = cs.build_corpus(np, cs.N_DOCS, cs.VOCAB, cs.SEED)
node = Node(name="msmarco", device=dev)
node.create_index("msmarco", {
    "settings": {"number_of_shards": 1},
    "mappings": {"properties": {"body": {"type": "text"}}}})
seg = segment_from_arrays({"num_docs": cs.N_DOCS, "max_docs": cs.N_DOCS,
                           "fields": {"body": cs.text_field(np, corpus)}},
                          node.residency)
node.get_index("msmarco").shards[0].engine.add_segment(seg)
dense = np.asarray(seg.inverted["body"].dense_block()[0][:cs.VOCAB]) >= 0
bodies = [{"query": {"match": {"body": " ".join(f"t{t}" for t in q)}},
           "size": 10}
          for q in cs.make_queries(np, cs.MSEARCH_BATCH, cs.VOCAB, corpus[4],
                                   cs.SEED, dense_only=dense)]


def singles():
    nxt, errs = itertools.count(), []

    def worker():
        while (i := next(nxt)) < len(bodies):
            try:
                node.search("msmarco", dict(bodies[i]))
            except Exception as e:
                errs.append(e)
                return

    threads = [threading.Thread(target=worker)
               for _ in range(cs.COALESCE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]


print("ready", file=out, flush=True)
for line in sys.stdin:
    arm = line.strip()
    if arm == "msearch":
        pairs = [({"index": "msmarco"}, copy.deepcopy(b)) for b in bodies]
        t = time.perf_counter()
        node.msearch(pairs)
    elif arm in ("coalesced", "off"):
        node.serving.apply_cluster_settings(
            {"serving.coalescer.mode": "adaptive" if arm == "coalesced"
             else "off"})
        t = time.perf_counter()
        singles()
    else:
        break
    print(f"{(time.perf_counter() - t) * 1e3:.3f}", file=out, flush=True)
node.close()
"""


def main():
    args = sys.argv[1:]
    pairs = 10
    if "--pairs" in args:
        at = args.index("--pairs")
        pairs = int(args[at + 1])
        del args[at:at + 2]
    if len(args) != 2:
        sys.exit(__doc__)
    procs = [subprocess.Popen([sys.executable, "-c", WORKER], cwd=tree,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True) for tree in args]
    try:
        for p, tree in zip(procs, args):
            if p.stdout.readline().strip() != "ready":
                sys.exit(f"{tree}: the worker did not start")

        def turn(n, arm):
            procs[n].stdin.write(arm + "\n")
            procs[n].stdin.flush()
            return float(procs[n].stdout.readline())

        for _ in range(2):
            for arm in ARMS:
                for n in (0, 1):
                    turn(n, arm)
        ms = {arm: [[], []] for arm in ARMS}
        for i in range(pairs):
            for arm in ARMS:
                for n in ((0, 1) if i % 2 == 0 else (1, 0)):
                    ms[arm][n].append(turn(n, arm))
    finally:
        for p in procs:
            p.stdin.close()
            p.wait(timeout=120)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; {pairs} alternating pairs, 1,024 bodies an arm")
    for arm in ARMS:
        for tree, xs in zip(args, ms[arm]):
            q1, med, q3 = statistics.quantiles(xs, n=4)
            print(f"{arm} {tree}: median {med:.3f} ms ({1024e3 / med:.1f} "
                  f"q/s), quartiles {q1:.3f} - {q3:.3f}, min {min(xs):.3f}, "
                  f"max {max(xs):.3f}; " + ", ".join(f"{x:.3f}" for x in xs))
        wins = sum(b < a for a, b in zip(*ms[arm]))
        print(f"{arm}: {args[1]} faster in {wins} of {pairs} pairs")


if __name__ == "__main__":
    main()
