"""Cluster-scale serving walkthrough on the PyTorch port: N prefill instances
behind SLO-aware dispatch, with decode-phase TPOT/TBT accounting — the
multi-instance scenario behind the paper's cluster-scale goodput claims.

Two modes share the SAME dispatch policy objects (repro_torch.core.dispatch):

  default — calibrated discrete-event ClusterSim (host only, no model):
      PYTHONPATH=src python examples/serve_cluster_torch.py [--instances 4]
          [--rate 24] [--burstiness 3] [--policy all]
          [--scenario fitted-chat]         # fitted/stress scenario trace
          [--hetero a800,a800,a100,a100]   # mixed-hardware pool
          [--decode-sched s-edf] [--decode-max-batch 16]
          [--decode-migration]             # TBT-slack-aware decode stage
          [--prefix-share]                 # shared-prefix trace + per-
          [--prefix-cache-blocks 2048]     # instance prefix KV caches

  --real  — a REAL model: Proxy + N threaded PrefillInstances sharing one
            executor (each with its own CUDA stream on the card) + one or
            two DecodeInstances, load-aware dispatch against live backlog
            (--prefix-share turns on the prefix-sharing PagedKVCache; add
            --scenario to replay a scenario's pacing and hash-chained
            prompts against it):
      PYTHONPATH=src python examples/serve_cluster_torch.py --real \
          --device cpu [--requests 10]           # the tiny config, host
      PYTHONPATH=src python examples/serve_cluster_torch.py --real \
          --full-config [--arch llama3_8b]       # published width, bf16

Chaos replay (--chaos churn | spot-wave | gray | seed:<int> | plan.json):
the SAME `FaultPlan` drives simulator instance churn and real fault
injection against the threaded pool (supervised recovery + watchdog) —
both modes report retries / sheds / lost:
      PYTHONPATH=src python examples/serve_cluster_torch.py --chaos churn
      PYTHONPATH=src python examples/serve_cluster_torch.py --real --chaos gray

The counterpart of examples/serve_cluster.py; the simulator mode prints
what that example prints. Real mode runs on the card unless ``--device
cpu``, with that example's tiny config or, with ``--full-config``, the
published width of ``--arch`` in bf16, random weights from ``--seed``. On
the card the analytic decode model that prices decode pressure is the
H100's (`repro_torch.sim.hardware.H100`; the A800 on the CPU, as in the
reference). The hang watchdog's period is 2 s on the tiny config, as in the
reference, and at published width 8x the slowest profiled prompt for each
instance on the card (`watchdog_period`); an injected hang lasts twice
that period (at most the event's duration), so the watchdog can see it.
"""
import argparse

from repro_torch.core.faults import FaultPlan
from repro_torch.sim.cluster import simulate_cluster
from repro_torch.traces.qwentrace import TraceConfig, generate

POLICIES = ["round-robin", "least-loaded", "deflection",
            "capacity-weighted", "decode-aware", "prefix-affinity"]


def _scenario_trace(args):
    from repro_torch.traces.scenarios import SCENARIOS, scenario_names
    sc = SCENARIOS.get(args.scenario)
    if sc is None:
        raise SystemExit(f"unknown scenario {args.scenario!r}; "
                         f"known: {scenario_names()}")
    print(f"scenario {sc.name!r}: {sc.summary}")
    print(f"  punishes: {sc.punishes}")
    return generate(TraceConfig(scenario=args.scenario, rate=args.rate,
                                duration=args.duration, seed=args.seed))


def _chaos_plan(args, n_instances):
    if not args.chaos:
        return None
    plan = FaultPlan.from_spec(args.chaos, n_instances=n_instances,
                               duration=args.duration)
    print(f"chaos plan {args.chaos!r}: {len(plan)} fault event(s)")
    for e in plan:
        rejoin = "never" if e.up_at == float("inf") else f"{e.up_at:.1f}s"
        print(f"  t={e.time:6.1f}s  {e.kind:8s} {e.target}[{e.instance}]"
              + (f" notice={e.notice}s" if e.kind == "spot" else "")
              + (f" x{e.factor}" if e.kind == "slowdown" else "")
              + f"  rejoin={rejoin}")
    return plan


def run_sim(args):
    hardware = args.hetero.split(",") if args.hetero else None
    n = len(hardware) if hardware else args.instances
    pool = " hetero[" + args.hetero + "]" if hardware else ""
    spec = f", spec-decode k={args.draft_k} accept={args.spec_accept}" \
        if args.spec_decode else ""
    print(f"== ClusterSim: {n} prefill + {n} decode instances{pool}, "
          f"rate={args.rate} req/s, burstiness={args.burstiness}{spec} ==")
    plan = _chaos_plan(args, n)
    if args.scenario:
        # scenario traces bring their own fitted output/TBT/prefix shape;
        # they always carry hash chains, so the prefix caches go live
        reqs = _scenario_trace(args)
        cache_blocks = args.prefix_cache_blocks
    else:
        share = dict(shared_prefix_frac=0.25, multi_turn_prob=0.75) \
            if args.prefix_share else {}
        reqs = generate(TraceConfig(rate=args.rate, duration=args.duration,
                                    seed=args.seed,
                                    burstiness=args.burstiness,
                                    output_mean=200, tbt_slo=args.tbt_slo,
                                    **share))
        cache_blocks = args.prefix_cache_blocks if args.prefix_share else 0
    print(f"{len(reqs)} requests "
          f"({sum(r.num_tokens for r in reqs)} prefill tokens)"
          + (f", prefix caches {cache_blocks} blocks/instance"
             if cache_blocks else ""))
    policies = POLICIES if args.policy == "all" else [args.policy]
    fault_cols = f" {'retry':>5s} {'shed':>4s} {'lost':>4s}" \
        if plan or args.shed_policy != "off" else ""
    print(f"{'dispatch':>17s} | {'TTFT att':>8s} {'e2e att':>8s} "
          f"{'p99/SLO':>7s} {'imbalance':>9s} {'preempts':>8s} "
          f"{'dec-pre':>7s} {'migr':>4s} {'hit':>5s}{fault_cols} "
          f"| per-instance dispatched")
    for policy in policies:
        res = simulate_cluster("flowprefill", reqs,
                               num_instances=n, dispatch=policy,
                               decode_instances=n, hardware=hardware,
                               decode_hardware=hardware,
                               decode_policy=args.decode_sched,
                               decode_max_batch=args.decode_max_batch,
                               decode_migration=args.decode_migration,
                               prefix_cache_blocks=cache_blocks,
                               fault_plan=plan, recovery=args.recovery,
                               shed_policy=args.shed_policy,
                               shed_budget=args.shed_budget,
                               spec_decode=args.spec_decode,
                               draft_k=args.draft_k,
                               spec_accept=args.spec_accept)
        faults = f" {res.retries:5d} {res.shed_requests:4d} " \
                 f"{res.lost_requests:4d}" if fault_cols else ""
        print(f"{policy:>17s} | {res.attainment:8.3f} "
              f"{res.e2e_attainment:8.3f} {res.e2e_p99_norm:7.2f} "
              f"{res.imbalance:9.2f} "
              f"{res.preemptions:8d} {res.decode_preemptions:7d} "
              f"{res.migrations:4d} {res.prefix_hit_rate:5.2f}{faults} "
              f"| {res.dispatched}")


# ----------------------------------------------------------------- real mode
REAL_MAX_SEQ = 2048
REAL_PROFILE = (256, 1024, 2048)


def real_config(args):
    """The reference example's tiny config, or `--arch` at its published
    width with `--full-config`."""
    import dataclasses

    from repro_torch.configs.base import get_config, get_tiny_config
    if args.full_config:
        return get_config(args.arch)
    return dataclasses.replace(get_tiny_config("llama3_8b"),
                               num_layers=2, d_model=128, d_ff=256)


def load_model(args, params=None):
    """(cfg, params, executor, profile): random weights from `--seed`
    unless `params` is given, the executor every instance shares, and the
    offline TTFT profile (each length warmed up, then timed with the
    device synchronised)."""
    from repro_torch.launch.serve import draw_params, ttft_profile
    from repro_torch.models.segments import SegmentedPrefill
    cfg = real_config(args)
    if params is None:
        params = draw_params(cfg, args.device, args.seed)
    ex = SegmentedPrefill(params, cfg, max_seq=REAL_MAX_SEQ,
                          granularity="op", chunk_tokens=512,
                          cache_dtype=params.dtype)
    return cfg, params, ex, ttft_profile(ex, REAL_PROFILE)


def watchdog_period(args, profile) -> float:
    """2 s on the tiny config (the reference's, sized for tiny CPU runs).
    At published width 8x the slowest profiled prompt for each instance
    that shares the card and this process: an honest step waits on the
    others' kernels and for the interpreter lock (a decode step beside
    four prefill instances took up to 2.9 s on an NVIDIA H100 at 700 W:
    16x the slowest 2048-token prompt alone, and 0.66 of a period at
    4x)."""
    if not args.full_config:
        return 2.0
    n_dec = 2 if args.decode_migration else 1
    return 8.0 * max(profile.values()) * (args.instances + n_dec)


class Cluster:
    """The real-mode deployment: `args.instances` PrefillInstances on one
    shared executor, one DecodeInstance (two with --decode-migration)
    behind a Proxy, and the chaos plan with the watchdog period it runs
    under (0 = off)."""

    def __init__(self, args, cfg, params, ex, profile, watchdog_s=None):
        from repro_torch.core import SchedulerCore, TTFTPredictor
        from repro_torch.serving.decode_instance import DecodeInstance
        from repro_torch.serving.prefill_instance import PrefillInstance
        from repro_torch.serving.proxy import Proxy
        from repro_torch.sim.costmodel import A800, DecodeCostModel, ModelSpec
        from repro_torch.sim.hardware import H100
        self.cfg = cfg
        xs, ys = list(profile), list(profile.values())
        pred = TTFTPredictor.fit(xs, ys)
        policy = args.policy if args.policy != "all" else "least-loaded"
        # --prefix-share: per-instance prefix-sharing PagedKVCache (each
        # instance keeps its own trie; the executor itself is stateless and
        # stays shared) — resubmitted prompts prefill suffix-only
        self.insts = [PrefillInstance(
            params, cfg, SchedulerCore(predictor=pred, enable_batching=False),
            max_seq=REAL_MAX_SEQ, executor=ex,
            prefix_share=args.prefix_share,
            prefix_cache_blocks=args.prefix_cache_blocks)
            for _ in range(args.instances)]
        # the decode flags apply here too: --decode-sched picks the
        # instances' admission policy, --decode-max-batch the continuous-
        # batching slot cap (the batched ragged step, paged KV),
        # --decode-migration needs >= 2 decode instances
        n_dec = 2 if args.decode_migration else 1
        # --spec-decode: the speculative path (self-drafting n-gram drafter
        # + one batched k+1-position verify pass per step, bit-identical
        # greedy output in f32); longer outputs give the drafter history
        # to match against
        self.out_tokens = 16 if args.spec_decode else 2
        self.decs = [DecodeInstance(params, cfg, decode_tokens=2,
                                    policy=args.decode_sched,
                                    decode_max_batch=max(
                                        args.decode_max_batch, 1),
                                    spec_decode=args.spec_decode,
                                    draft_k=args.draft_k)
                     for _ in range(n_dec)]
        # wire the hetero-pool signals so capacity-weighted / decode-aware
        # run against real measurements, not silent 1.0/0.0 defaults:
        # capacity from the measured profile (identical executors ->
        # identical capacities), decode pressure priced by the analytic
        # decode model for this config on this device's hardware
        hw = H100 if ex.device.type == "cuda" else A800
        cap = xs[-1] / ys[-1]                  # measured prefill tokens/s
        self.plan = _chaos_plan(args, args.instances)
        if watchdog_s is None:
            has_hang = self.plan is not None and \
                any(e.kind == "hang" for e in self.plan)
            watchdog_s = watchdog_period(args, profile) if has_hang else 0.0
        self.watchdog_s = watchdog_s
        self.proxy = Proxy(self.insts, self.decs, dispatch=policy,
                           capacities=[cap] * args.instances,
                           decode_cost=DecodeCostModel(
                               ModelSpec.from_config(cfg), hw),
                           decode_migration=args.decode_migration,
                           recovery=args.recovery,
                           shed_policy=args.shed_policy,
                           shed_budget=args.shed_budget,
                           watchdog_s=watchdog_s)

    def prefill_logits(self, reqs):
        """Each request's first-token logits from every prefill that
        completed it (a request retried after its decode failed has more
        than one), in the order of `reqs`."""
        rows = {r.rid: [] for r in reqs}
        for inst in self.insts:
            for task in inst.completed_tasks:
                for i, r in enumerate(task.requests):
                    if r.rid in rows:
                        rows[r.rid].append(task.prefill_task.logits[i])
        return [rows[r.rid] for r in reqs]

    def shutdown(self):
        self.proxy.shutdown()


def serve(args, cl: Cluster, drain_timeout: float = 300.0):
    """Submit `args.requests` prompts (drawn from `--seed`, or a
    scenario's), inject the chaos plan's faults in request-index space,
    drain, and return (`Proxy.report()`, the requests in submission
    order)."""
    import threading
    import time

    import numpy as np

    from repro_torch.core import Request
    cfg, proxy, insts, decs = cl.cfg, cl.proxy, cl.insts, cl.decs
    rng = np.random.default_rng(args.seed)

    # replay the plan in request-index space: event time t maps to "after
    # submission floor(t / duration * requests)", so a fault scheduled
    # mid-trace lands mid-stream regardless of real-mode pacing. Outages
    # are capped at 5s (the demo run is seconds, not the sim's minutes).
    chaos_by_i = {}
    revive_timers = []
    if cl.plan is not None:
        for e in cl.plan:
            i = min(int(e.time / args.duration * args.requests),
                    args.requests - 1)
            chaos_by_i.setdefault(i, []).append(e)

    def fire(e):
        kind, idx = e.target, e.instance
        j = idx % (args.instances if kind == "prefill" else len(decs))
        outage = min(e.duration, 5.0)
        if e.kind in ("crash", "spot"):
            # spot notice is sub-second here; treat both as a kill + rejoin
            proxy.kill_instance(j, kind)
            t = threading.Timer(outage, proxy.revive_instance, args=(j, kind))
            t.daemon = True
            t.start()
            revive_timers.append(t)
            print(f"  [chaos] {e.kind} {kind}[{j}] (rejoin in {outage:.1f}s)")
        elif e.kind == "hang":
            target = insts[j] if kind == "prefill" else decs[j]
            hang = min(e.duration, 2.0 * cl.watchdog_s)
            target.inject_fault(("hang", hang))
            t = threading.Timer(outage, proxy.revive_instance, args=(j, kind))
            t.daemon = True
            t.start()
            revive_timers.append(t)
            print(f"  [chaos] hang {kind}[{j}] for {hang:.2f}s (watchdog "
                  f"{cl.watchdog_s:.2f}s will strand it)")
        else:
            print(f"  [chaos] {e.kind} not modeled in --real mode; skipped")
    scen = _scenario_trace(args)[:args.requests] if args.scenario else None

    def scenario_tokens(src, n):
        # block content derived from the chain key: equal keys -> equal
        # tokens, so resubmitted prefixes (multi-turn chains, templates)
        # genuinely hit the real PagedKVCache trie instead of merely
        # colliding in the sim's residency model
        toks = rng.integers(0, cfg.vocab_size, n)
        for bi, key in enumerate((src.prefix_hash or ())[:n // 128]):
            block_rng = np.random.default_rng(key & 0xFFFFFFFF)
            toks[bi * 128:(bi + 1) * 128] = \
                block_rng.integers(0, cfg.vocab_size, 128)
        return toks

    reqs = []
    try:
        prev_arrival = scen[0].arrival if scen else 0.0
        for i in range(args.requests):
            if scen and i < len(scen):
                # replay the scenario's task mix, pacing, and hash-chained
                # prompts (truncated to max_seq); SLOs use the real-mode
                # convention — the scenario's SLOs are the A800's
                src = scen[i]
                n = min(src.num_tokens, REAL_MAX_SEQ)
                req = Request(num_tokens=n, slo=5.0 if n <= 256 else 30.0,
                              arrival=time.monotonic(),
                              task_type=src.task_type,
                              output_tokens=cl.out_tokens, tbt_slo=2.0,
                              prefix_hash=(src.prefix_hash or ())[:n // 128])
                proxy.submit(req, scenario_tokens(src, n))
                gap, prev_arrival = src.arrival - prev_arrival, src.arrival
                time.sleep(min(max(gap, 0.0), 0.5))
            else:
                n = int(rng.choice([256, 256, 1024, 2048]))
                req = Request(num_tokens=n, slo=5.0 if n <= 256 else 30.0,
                              arrival=time.monotonic(),
                              output_tokens=cl.out_tokens, tbt_slo=2.0)
                proxy.submit(req, rng.integers(0, cfg.vocab_size, n))
                time.sleep(float(rng.exponential(0.15)))
            reqs.append(req)
            for e in chaos_by_i.pop(i, ()):
                fire(e)
        if not proxy.drain(drain_timeout):
            rep = proxy.report()
            raise SystemExit(
                f"drain timed out: {len(rep['stranded_rids'])} request(s) "
                f"stranded (rids {rep['stranded_rids']}), instance health "
                f"{rep['instance_health']}")
        time.sleep(0.5)
        return proxy.report(), reqs
    finally:
        for t in revive_timers:
            t.cancel()


def print_real(args, cl: Cluster, rep):
    print(f"  requests={rep['n_requests']} "
          f"dispatched={rep['dispatched_by_instance']}")
    print(f"  SLO attainment={rep['slo_attainment']:.2f} "
          f"TTFT mean={rep['ttft']['mean']:.3f}s "
          f"p99={rep['ttft']['p99']:.3f}s "
          f"e2e p99/SLO={rep['percentiles']['e2e_p99_norm']:.2f}")
    print(f"  decoded={sum(len(d.finished) for d in cl.decs)} "
          f"decode_migrations={rep['decode_migrations']} "
          f"decode_preemptions={rep['decode_preemptions']}")
    if args.spec_decode:
        sp = rep["spec"]
        print(f"  spec: steps={sp['spec_steps']} "
              f"accept={sp['accept_rate']:.2f} "
              f"tokens/step={sp['tokens_per_step']:.2f} "
              f"(drafted {sp['draft_proposed']}, "
              f"accepted {sp['draft_accepted']})")
    if cl.plan is not None or args.shed_policy != "off":
        served = rep["n_requests"] - rep["lost_requests"] \
            - rep["shed_requests"]
        print(f"  chaos: retries={rep['retries']} "
              f"shed={rep['shed_requests']} "
              f"lost={rep['lost_requests']} "
              f"watchdog fires={rep['watchdog_fires']} "
              f"recovered goodput={served}/{rep['n_requests']} served "
              f"(health {rep['instance_health']})")


def run_real(args):
    cfg, params, ex, profile = load_model(args)
    dev = ex.device
    print(f"== real mode: {args.instances} PrefillInstances ({cfg.name}, "
          f"{params.dtype} on {dev}), dispatch={args.policy} ==")
    print("  TTFT profile: " + ", ".join(
        f"{n} tokens {t*1e3:.1f} ms" for n, t in profile.items()))
    cl = Cluster(args, cfg, params, ex, profile)
    if cl.watchdog_s > 0:
        print(f"  hang watchdog period {cl.watchdog_s:.3f}s")
    try:
        rep, _ = serve(args, cl)
        print_real(args, cl, rep)
        return rep
    finally:
        cl.shutdown()


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=4)
    ap.add_argument("--rate", type=float, default=24.0)
    ap.add_argument("--duration", type=float, default=40.0)
    ap.add_argument("--burstiness", type=float, default=3.0)
    ap.add_argument("--policy", default="all",
                    choices=["all"] + POLICIES)
    ap.add_argument("--scenario", default=None,
                    help="fitted/stress scenario trace (repro_torch.traces."
                    "scenarios; see docs/TRACES.md). Sim mode runs the "
                    "scenario against each dispatch policy with prefix "
                    "caches on; --real replays its pacing, task mix, and "
                    "hash-chained prompt content (block tokens derived "
                    "from chain keys, so shared prefixes hit the real "
                    "PagedKVCache). Overrides --burstiness/--prefix-share "
                    "trace shaping")
    ap.add_argument("--hetero", default=None, metavar="HW,HW,...",
                    help="comma-separated per-instance hardware "
                    "(a800 / a100 / tpu-v5e); overrides --instances")
    ap.add_argument("--tbt-slo", type=float, default=0.02,
                    help="decode TBT SLO (s/token); tight values make the "
                    "decode-aware policy visible on mixed pools")
    ap.add_argument("--decode-sched", default="fcfs",
                    choices=["fcfs", "s-edf"],
                    help="decode batch-admission policy (s-edf = TBT-slack-"
                    "aware with token-boundary preemption)")
    ap.add_argument("--decode-max-batch", type=int, default=0,
                    help="decode KV slot cap per instance. Sim mode: 0 = "
                    "unbounded processor sharing (scheduling needs a cap to "
                    "matter). Real mode: the continuous-batching slot count "
                    "of the batched decode step (min 1)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decoding. Sim mode: fluid multi-token "
                    "advancement at --spec-accept per-token acceptance; "
                    "--real: the actual self-drafting n-gram drafter + "
                    "batched verify pass (the verify kernel on the card)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per speculative step")
    ap.add_argument("--spec-accept", type=float, default=0.7,
                    help="sim mode: per-token draft accept probability "
                    "(--real measures the real n-gram accept rate instead)")
    ap.add_argument("--decode-migration", action="store_true",
                    help="cost-gated migration of queued decodes off "
                    "instances past the TBT knee")
    ap.add_argument("--prefix-share", action="store_true",
                    help="block-level prefix sharing: sim mode generates a "
                    "shared-prefix trace (system prompts + multi-turn) and "
                    "gives every instance a prefix cache; real mode turns "
                    "on the prefix-sharing PagedKVCache (pair with "
                    "--policy prefix-affinity to route onto cached KV)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=2048,
                    help="prefix cache capacity per instance, in KV blocks "
                    "of 128 tokens (with --prefix-share)")
    ap.add_argument("--chaos", default=None, metavar="PLAN",
                    help="replay a FaultPlan: a preset (churn, spot-wave, "
                    "gray), seed:<int> for a generated schedule, or a JSON "
                    "file from FaultPlan.to_json. Sim mode feeds it to "
                    "ClusterSim; --real injects the same faults into the "
                    "threaded pool (kill/revive + hang watchdog)")
    ap.add_argument("--recovery", default="retry",
                    choices=["retry", "none"],
                    help="stranded-work handling under --chaos: re-dispatch "
                    "with backoff (retry) or count as lost (none, the "
                    "naive baseline)")
    ap.add_argument("--shed-policy", default="off",
                    choices=["off", "doomed-only", "budget"],
                    help="SLO-aware admission control (docs/SCHEDULING.md): "
                    "reject doomed arrivals at the proxy instead of letting "
                    "them poison the tail")
    ap.add_argument("--shed-budget", type=float, default=2.0,
                    help="budget policy: shed when predicted TTFT > "
                    "budget x SLO")
    ap.add_argument("--seed", type=int, default=3,
                    help="seed of the trace, the prompts and (real mode) "
                    "the random weights")
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--requests", type=int, default=10,
                    help="request count in --real mode")
    ap.add_argument("--full-config", action="store_true",
                    help="real mode: --arch at its published width in bf16")
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--device", default="cuda",
                    help="real mode: the device (the simulator runs on "
                    "the host)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)
    if args.decode_migration and args.decode_max_batch <= 0 and not args.real:
        ap.error("--decode-migration migrates QUEUED decodes: set "
                 "--decode-max-batch > 0 (unbounded decode never queues)")
    if args.real:
        return run_real(args)
    run_sim(args)


if __name__ == "__main__":
    main()
