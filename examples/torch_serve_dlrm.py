"""End-to-end serving example on the PyTorch port: the full FlexEMR pipeline
over a diurnal request trace — bucketed batching, the §3.2 multi-threaded
rdma engine pool with pooling pushdown (near-memory segment reduction
composed with the wire dedup; the exit summary's ``pushdown`` block reports
the request- vs response-direction byte split), cross-batch pipelining, the
adaptive cache controller (whose per-shard heat also drives the pool's
skew-aware dealing), pool-side straggler hedging (cancel-the-loser), and the
dense ranker on ``--device`` (default ``cuda``: its dot interaction is
kernel K2, once a batch; ``--device cpu`` runs it on the host).

  PYTHONPATH=src python examples/torch_serve_dlrm.py --requests 2000
  PYTHONPATH=src python examples/torch_serve_dlrm.py --requests 2000 --no-pushdown    # gather+pool ablation
  PYTHONPATH=src python examples/torch_serve_dlrm.py --requests 2000 --engine legacy  # pre-pool engine
  PYTHONPATH=src python examples/torch_serve_dlrm.py --requests 2000 --pipeline-depth 1  # closed loop
  PYTHONPATH=src python examples/torch_serve_dlrm.py --requests 2000 \
      --trace trace.json --metrics-out metrics.json  # observability
      # (load trace.json in https://ui.perfetto.dev, or summarize with
      #  python tools/trace_export.py trace.json --summarize, or render the
      #  per-request latency breakdown with ... --attribution)
  PYTHONPATH=src python examples/torch_serve_dlrm.py \
      --arrival poisson --qps 2000 --duration 5  # open-loop load: seeded
      # Poisson arrivals at the offered rate (queueing delay measured, not
      # hidden); prints the slo.* summary (burn rates, goodput) at exit
  PYTHONPATH=src python examples/torch_serve_dlrm.py \
      --arrival poisson --qps 4000 --duration 5 --deadline-ms 50 \
      --admission --retry-budget 0.1 --degrade-policy degrade
      # overload response: deadline admission sheds unmeetable requests at
      # the door (serve.admission.* in the exit summary), the retry ladder
      # re-flies flaky/storm-slowed WRs under a bounded budget
      # (rdma.retry.*), and dropped-shard cold rows answer as flagged
      # brownout partials instead of parking (serve.degraded.*)
  PYTHONPATH=src python examples/torch_serve_dlrm.py --device cpu --requests 200 --scale 0.05
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import parse_args, run


def main(argv=None) -> dict:
    """Serve with ``launch.serve``'s flags; returns its summary (also logged
    as JSON at exit)."""
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
