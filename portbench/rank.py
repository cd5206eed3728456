"""A rank of a multi-card run other than rank 0: ``python -m
portbench.rank --port P --rank R --world W --spec JSON``, started by
``portbench.launch.start_ranks``. It joins the run's store, runs its part
of the cell's driver, puts its result (or its error) in the store, and
exits; it dies with the run's process."""

import argparse
import json
import sys
import time
import traceback
from datetime import timedelta


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--spec", required=True)
    args = ap.parse_args(argv)
    spec = json.loads(args.spec)

    import torch.distributed as dist

    from .cells import Cell

    store = dist.TCPStore("127.0.0.1", args.port, args.world, False,
                          timeout=timedelta(seconds=spec["store_timeout_s"]))
    try:
        cell = Cell.from_spec(spec["cell"])
        result = cell.driver().rank_main(cell, args.rank, args.world, store, spec, t_start)
        store.set(f"result/{args.rank}", json.dumps(result))
    except BaseException:
        msg = traceback.format_exc()
        print(msg, file=sys.stderr, flush=True)
        store.set(f"error/{args.rank}", msg[-4000:])
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
