"""The knee of an open-loop serving cell: Poisson arrivals at each of
several rates, one server built once, a fresh load generator per rate.

    python3 benchmark/knee.py --workload xl-t2a.serve-poisson --seed 7 \
        --rates 4.0,4.5,5.0,5.5,6.0 --seconds 30 [--schedule-seed 8] \
        [--out chiprun_out/knee.jsonl]

For each rate it reports p50 and p95 from when each request was due, the
rows of each batch launched, and the backlog (sent and not yet answered):
its mean over the first and the last third of the window. The knee is the
highest rate at which the backlog does not grow over the window: the last
third's mean within a quarter of a full batch of the first third's. A rate
may be given more than once: the k-th window's requests (captions and
noise seeds, not arrivals) come from seed + k, as different runs' seeds
give them."""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import numpy as np  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.traffic import serve  # noqa: E402
from benchmark.weights import sub_seed  # noqa: E402


def backlog(res, t0, a, b, step=0.1):
    ts = np.arange(t0 + a, t0 + b, step)
    sent = np.array([r["due"] for r in res])
    done = np.array([r["done"] for r in res])
    return float(np.mean([(sent <= t).sum() - (done <= t).sum() for t in ts]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--rates", required=True)
    p.add_argument("--schedule-seed", type=int, default=None,
                   help="draw the arrivals from this seed (default: the cell's schedule_seed)")
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    from maa3_tpu_torch.serving import AudioServer, ServeConfig
    harness.cache_env(ROOT)
    bench = harness.Bench(ROOT)
    cell = bench.cell(a.workload)
    cfg, P = bench.config(cell["config"]), dict(cell["params"])
    if a.schedule_seed is not None:
        P["schedule_seed"] = a.schedule_seed
    device = torch.device("cuda", 0)
    system = harness.build_system(cfg, a.seed, device, P["latent_len"])
    server = AudioServer(system, ServeConfig(
        default_steps=P["steps"], default_scale=P["scale"], seed=sub_seed(a.seed, "server", 31),
        **P["server"]), host="127.0.0.1", port=0)
    server.batcher.warmup(tuple(P["warm_buckets"]), steps=P.get("warm_steps", 2))
    launches = serve.Launches(server.batcher)
    server.start()
    try:
        for k, rate in enumerate(float(r) for r in a.rates.split(",")):
            P["rate_rps"] = rate
            due = serve.arrivals(P, a.seconds)
            bodies = serve.requests(P, a.seed + k, len(due))
            client = subprocess.Popen([sys.executable, str(harness.PKG / "client.py")],
                                      stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
            client.stdout.readline()
            t0 = time.monotonic() + 0.5
            client.stdin.write(json.dumps({"loop": "open", "due": due, "port": server.port,
                                           "t0": t0, "requests": bodies,
                                           "timeout": a.seconds + 300.0}) + "\n")
            client.stdin.flush()
            res = json.loads(client.stdout.readline())["results"]
            client.stdin.write(json.dumps({"indices": []}) + "\n")
            client.stdin.flush()
            client.stdout.readline()
            client.wait(timeout=60)
            lat = [(r["done"] - r["due"]) * 1e3 for r in res]
            third = a.seconds / 3
            rec = {"workload": a.workload, "seed": a.seed + k,
                   "schedule_seed": P["schedule_seed"], "rate_rps": rate,
                   "seconds": a.seconds, "requests": len(res),
                   "failed": sum(r["status"] != 200 for r in res),
                   "p50_ms": harness.percentile(lat, 50), "p95_ms": harness.percentile(lat, 95),
                   "backlog_first_third": backlog(res, t0, 0.0, third),
                   "backlog_last_third": backlog(res, t0, 2 * third, a.seconds),
                   "batches": launches.rows_since(t0)}
            rec["grows"] = (rec["backlog_last_third"] - rec["backlog_first_third"]
                            > P["server"]["max_batch"] / 4)
            line = json.dumps(rec)
            print(line, flush=True)
            if a.out:
                Path(a.out).parent.mkdir(parents=True, exist_ok=True)
                with open(a.out, "a") as f:
                    f.write(line + "\n")
            time.sleep(2.0)  # the queue drains before the next rate
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
