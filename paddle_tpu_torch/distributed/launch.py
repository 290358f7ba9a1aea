"""``python -m paddle_tpu_torch.distributed.launch``: the job launcher
(port of paddle_tpu/distributed/launch.py; the reference's parity:
python/paddle/distributed/fleet/launch.py, launch_collective at :223,
launch_ps at :292, and launch_utils.py: start_local_trainers :449,
watch_local_trainers :522, env names :473-476, log management).

Collective mode launches one supervised trainer a host, as the reference
does (``--nproc_per_node`` is accepted and held at 1: the trainer drives
its host's cards itself, e.g. ``LoopbackWorld`` ranks or its own
``init_process_group``).  Multi-host jobs pass ``--ips``; rank and world
come from this host's position in the list.  PS mode
(``--server_num/--worker_num``) launches N parameter-server processes and
M trainers with the TRAINING_ROLE env protocol.  Every child is
supervised: stdout/stderr go to ``log_dir/{worker,server}log.N``, and if a
child dies the rest are terminated and the launcher exits with the
failing code (the watch_local_trainers contract), unless
``--elastic_retries`` restarts it or ``--elastic_store`` hands the
children to the ``ElasticAgent`` (crash, hang and lease watchdogs).
``--collector`` starts the cluster telemetry collector in the launcher
and exports its endpoint to every child.

The plain path imports nothing of the framework: the flight recorder,
the elastic agent and the collector are imported only when a child has
failed, an elastic store is given or a collector is asked for.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import time
from typing import Dict, List, Optional

__all__ = ["main"]


def _parse():
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--ips", type=str, default="127.0.0.1",
                   help="comma-separated host ips (reference --ips)")
    p.add_argument("--gpus", "--xpus", "--devices", type=str, default=None,
                   help="accepted for parity; the trainer finds its cards")
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="held at 1: one trainer a host")
    p.add_argument("--backend", type=str, default="nccl")
    p.add_argument("--server_num", type=int, default=0,
                   help="PS mode: parameter servers on this host")
    p.add_argument("--worker_num", type=int, default=0,
                   help="PS mode: trainers on this host")
    p.add_argument("--start_port", type=int,
                   default=int(os.getenv("FLAGS_START_PORT", "6070")))
    p.add_argument("--elastic_retries", type=int, default=0,
                   help="restart a failed child up to N times before "
                        "failing the job (elastic/failure-recovery role "
                        "of the reference's elastic manager)")
    p.add_argument("--restart_backoff", type=float, default=0.5,
                   help="base restart delay (s): a crashed child waits "
                        "backoff*2^restarts (capped at 10s) before its "
                        "next incarnation, so a crash-looping child "
                        "cannot burn the whole retry budget in ~1s")
    p.add_argument("--healthy_interval", type=float, default=30.0,
                   help="seconds of continuous child life after which "
                        "its restart budget resets to 0")
    p.add_argument("--elastic_store", type=str, default="",
                   help="directory for the elastic rendezvous FileStore; "
                        "when set, children are supervised by the "
                        "ElasticAgent (crash + hang + lease watchdogs, "
                        "shrink-to-survive) instead of plain "
                        "watch_local_trainers polling")
    p.add_argument("--lease_ttl", type=float, default=10.0,
                   help="elastic: lease seconds before a silent worker "
                        "is expired (membership epoch bump)")
    p.add_argument("--hang_deadline", type=float, default=60.0,
                   help="elastic: kill a child whose progress beat is "
                        "older than this (hung/straggler detection; only "
                        "applies once the child has beaten at least once)")
    p.add_argument("--term_grace", type=float, default=0.0,
                   help="elastic: SIGTERM grace seconds granted before "
                        "any kill — the preemption window a child's "
                        "crash-handler chain spends on its deadline-"
                        "bounded emergency checkpoint save "
                        "(FLAGS_ckpt_emergency_deadline); 0 keeps the "
                        "classic immediate SIGKILL")
    p.add_argument("--collector", action="store_true",
                   help="start a central telemetry collector "
                        "(framework/collector.py) inside the launcher "
                        "and export its endpoint to EVERY child — "
                        "server and trainer roles alike — as "
                        "PADDLE_COLLECTOR_ENDPOINT; straggler scores "
                        "feed the elastic agent when --elastic_store "
                        "is also set")
    p.add_argument("--collector_endpoint", type=str, default="",
                   help="push child telemetry to an EXTERNAL collector "
                        "at host:port instead of starting one "
                        "in-launcher")
    p.add_argument("--collector_ledger", type=str, default="",
                   help="in-launcher collector: append cluster-level "
                        "RunRecords (straggler report included) to "
                        "this run-ledger path on 'capture' ops")
    p.add_argument("training_script", type=str)
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p.parse_args()


def _my_rank(ips):
    hostname_ips = set()
    try:
        hostname_ips.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    hostname_ips.add("127.0.0.1")
    hostname_ips.add("localhost")
    for i, ip in enumerate(ips):
        if ip in hostname_ips:
            return i
    return int(os.getenv("PADDLE_TRAINER_ID", "0"))


class _Child:
    """launch_utils.py TrainerProc: process + its log file + identity."""

    def __init__(self, name: str, cmd: List[str], env: Dict[str, str],
                 log_path: Optional[str]):
        self.name = name
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.restarts = 0
        self._spawn()

    def _spawn(self):
        import subprocess
        self.log_file = open(self.log_path, "a") if self.log_path else None
        full_env = dict(os.environ)
        full_env.update(self.env)
        self.proc = subprocess.Popen(
            self.cmd, env=full_env,
            stdout=self.log_file or None,
            stderr=subprocess.STDOUT if self.log_file else None)

    def restart(self):
        if self.log_file and not self.log_file.closed:
            self.log_file.close()
        self.restarts += 1
        self._spawn()

    def alive(self):
        return self.proc.poll() is None

    def terminate(self, grace: float = 5.0):
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace)
            except Exception:          # noqa: BLE001
                self.proc.kill()
                try:
                    # reap: without this wait the SIGKILLed child stays
                    # a zombie for the launcher's whole lifetime
                    self.proc.wait(timeout=5)
                except Exception:      # noqa: BLE001
                    pass
        if self.log_file and not self.log_file.closed:
            self.log_file.close()


def _supervise(children: List[_Child], elastic_retries: int = 0,
               restart_backoff: float = 0.5, backoff_cap: float = 10.0,
               healthy_interval: float = 30.0,
               poll_interval: float = 0.2) -> int:
    """watch_local_trainers (launch_utils.py:522): poll; a non-zero exit
    restarts the child while elastic retries remain, else kills the job;
    success when every child exits 0.

    Restarts are paced: a crashed child waits ``restart_backoff *
    2^restarts`` (capped) before its next incarnation — an instantly
    dying child can no longer burn the whole retry budget in about a
    second — and a child that then stays alive for ``healthy_interval``
    earns its budget back (a crash tomorrow should not be charged for a
    crash last week)."""

    def _sig(_s, _f):
        for c in children:
            c.terminate()
        sys.exit(1)

    def _flight():
        # lazy: the plain launcher path must not import the framework
        # (and init a backend) while the job is healthy — the recorder
        # is only needed once a child has already crashed
        try:
            from paddle_tpu_torch.framework.observability import flight
            return flight
        except Exception:              # noqa: BLE001
            return None

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    pending: Dict[str, float] = {}        # name -> restart-at monotonic
    alive_since: Dict[str, float] = {}
    try:
        while True:
            now = time.monotonic()
            alive = False
            for c in children:
                if c.name in pending:
                    if now >= pending[c.name]:
                        del pending[c.name]
                        c.restart()
                        alive_since[c.name] = time.monotonic()
                    alive = True          # job still in flight
                    continue
                rc = c.proc.poll()
                if rc is None:
                    alive = True
                    if (now - alive_since.setdefault(c.name, now)
                            >= healthy_interval and c.restarts):
                        print(f"launch: {c.name} healthy for "
                              f"{healthy_interval:g}s — restart budget "
                              "reset", file=sys.stderr)
                        c.restarts = 0
                elif rc != 0:
                    fl = _flight()
                    if c.restarts < elastic_retries:
                        delay = min(restart_backoff * (2 ** c.restarts),
                                    backoff_cap)
                        print(f"launch: {c.name} exited with {rc}; "
                              f"elastic restart "
                              f"{c.restarts + 1}/{elastic_retries} "
                              f"in {delay:.2f}s", file=sys.stderr)
                        if fl is not None:
                            fl.record("launch.restart_scheduled",
                                      severity="warn", worker=c.name,
                                      rc=rc, delay=delay)
                        pending[c.name] = now + delay  # restart() bumps
                                                       # c.restarts
                        alive = True
                        continue
                    print(f"launch: {c.name} exited with {rc}"
                          + (f", see {c.log_path}" if c.log_path else ""),
                          file=sys.stderr)
                    if fl is not None:
                        fl.record("launch.child_failed", severity="error",
                                  worker=c.name, rc=rc, log=c.log_path)
                        # post-mortem artifact: the supervisor's own view
                        # of the failing child (exits, restarts, pacing)
                        # next to its log; a log-less child (tests) has
                        # no artifact directory and gets no dump.  When
                        # the child's own crash handler already dumped
                        # under flight_<name>.json (richer: the actual
                        # fault trips/retries), keep it and write the
                        # supervisor view beside it
                        if c.log_path:
                            d = os.path.dirname(c.log_path) or "."
                            p = os.path.join(d, f"flight_{c.name}.json")
                            if os.path.exists(p):
                                p = os.path.join(
                                    d, f"flight_{c.name}.supervisor.json")
                            try:
                                fl.dump(p, worker=c.name)
                            except OSError:
                                pass
                    for o in children:
                        if o is not c:
                            o.terminate()
                    return rc
            if not alive:
                return 0
            time.sleep(poll_interval)
    finally:
        for c in children:
            if c.log_file and not c.log_file.closed:
                c.log_file.close()


def _run_supervisor(args, children: List[_Child],
                    members: Optional[List[_Child]] = None,
                    endpoints: Optional[Dict[str, str]] = None,
                    collector=None) -> int:
    """Route to the elastic agent (crash + hang + lease watchdogs) when a
    rendezvous store is configured, else classic watch_local_trainers.
    ``members`` is the subset that joins the rendezvous MEMBERSHIP (the
    trainers); PS servers are supervised but never appear in the world a
    refreshed role maker ranks against.  ``endpoints`` maps member name
    to its host:port so a refreshed role maker hands out real trainer
    endpoints, not bare child names.  ``collector`` is the in-launcher
    CollectorServer (when --collector armed): its straggler reports
    feed the elastic agent, so the supervisor that today only sees
    hangs also sees slow-but-alive workers."""
    if not args.elastic_store:
        try:
            return _supervise(children, args.elastic_retries,
                              restart_backoff=args.restart_backoff,
                              healthy_interval=args.healthy_interval)
        finally:
            if collector is not None:
                collector.shutdown()
    from paddle_tpu_torch.distributed.elastic import (
        ElasticAgent, FileStore, ProcHandle)
    store = FileStore(os.path.join(args.elastic_store, "rendezvous.json"),
                      ttl=args.lease_ttl)
    members = children if members is None else members
    for c in members:
        store.register(c.name, endpoint=(endpoints or {}).get(c.name))
    agent = ElasticAgent(store, [ProcHandle(c) for c in children],
                         hang_deadline=args.hang_deadline,
                         elastic_retries=args.elastic_retries,
                         restart_backoff=args.restart_backoff,
                         healthy_interval=args.healthy_interval,
                         log=lambda m: print(m, file=sys.stderr),
                         member_names=[c.name for c in members],
                         endpoints=endpoints,
                         term_grace=args.term_grace)
    if collector is not None:
        # cluster straggler scores flow into the agent's view: the
        # hang watchdog sees dead-silent workers, the collector sees
        # merely-slow ones
        collector.on_straggler = \
            lambda scores, flagged: agent.note_stragglers(scores, flagged)

    def _sig(_s, _f):
        for c in children:
            c.terminate()
        sys.exit(1)

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    try:
        return agent.run()
    finally:
        if collector is not None:
            collector.shutdown()


def _elastic_env(args, name: str) -> Dict[str, str]:
    """Extra env for children of an elastic launch: where the store is
    and who they are, so an elastic-aware trainer can beat progress /
    renew its own lease / refresh its role maker on epoch bumps."""
    if not args.elastic_store:
        return {}
    return {
        "PADDLE_ELASTIC_STORE": os.path.join(args.elastic_store,
                                             "rendezvous.json"),
        "PADDLE_ELASTIC_WORKER_ID": name,
        "PADDLE_ELASTIC_LEASE_TTL": str(args.lease_ttl),
    }


def _start_collector(args):
    """Start the in-launcher collector when ``--collector`` asks for
    one; returns ``(collector_server_or_None, endpoint_or_None)``.
    Lazy import: the plain launcher path must stay framework-free."""
    if getattr(args, "collector", False):
        from paddle_tpu_torch.framework.collector import CollectorServer
        srv = CollectorServer(
            ledger_path=args.collector_ledger or None).start()
        print(f"launch: telemetry collector on {srv.endpoint}",
              file=sys.stderr)
        return srv, srv.endpoint
    ep = getattr(args, "collector_endpoint", "") or ""
    return None, (ep or None)


def _collector_env(endpoint: Optional[str], role: str) -> Dict[str, str]:
    """Telemetry env every child gets — server AND trainer roles: the
    collector endpoint (when armed) and the child's role, so pushed
    snapshots and span files are labeled per role, not just per
    worker."""
    env = {"PADDLE_ROLE": role}
    if endpoint:
        env["PADDLE_COLLECTOR_ENDPOINT"] = endpoint
    return env


def _launch_collective(args, ips) -> int:
    rank = _my_rank(ips)
    endpoints = [f"{ip}:{args.start_port}" for ip in ips]
    if args.nproc_per_node != 1:
        print("launch: nproc_per_node held at 1: one trainer drives this "
              "host's cards", file=sys.stderr)
    env = {
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(len(ips)),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
        "PADDLE_CURRENT_ENDPOINT": endpoints[rank] if rank < len(endpoints)
        else endpoints[0],
    }
    name = f"trainer-{rank}"
    env["PADDLE_TRACE_LABEL"] = name   # per-process span file when
    env.update(_elastic_env(args, name))   # FLAGS_trace_dir is armed
    collector, col_ep = _start_collector(args)
    env.update(_collector_env(col_ep, "trainer"))
    os.makedirs(args.log_dir, exist_ok=True)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    child = _Child(name, cmd, env,
                   os.path.join(args.log_dir, f"workerlog.{rank}"))
    return _run_supervisor(args, [child],
                           endpoints={name: env["PADDLE_CURRENT_ENDPOINT"]},
                           collector=collector)


def _launch_ps(args) -> int:
    """launch_ps: servers first, then trainers, one env block each."""
    n_s, n_w = args.server_num, args.worker_num
    server_eps = [f"127.0.0.1:{args.start_port + i}" for i in range(n_s)]
    worker_eps = [f"127.0.0.1:{args.start_port + n_s + i}"
                  for i in range(n_w)]
    os.makedirs(args.log_dir, exist_ok=True)
    cmd = [sys.executable, args.training_script] + args.training_script_args
    common = {
        "PADDLE_PSERVERS_IP_PORT_LIST": ",".join(server_eps),
        "PADDLE_TRAINER_ENDPOINTS": ",".join(worker_eps),
        "PADDLE_TRAINERS_NUM": str(n_w),
    }
    collector, col_ep = _start_collector(args)
    children = []
    for i in range(n_s):
        # server children get the SAME telemetry env as trainers: a
        # per-role trace label AND the collector endpoint, so PS-shard
        # span files and pushed snapshots are attributable per role
        env = dict(common, TRAINING_ROLE="PSERVER",
                   PADDLE_PSERVER_ID=str(i),
                   PADDLE_PORT=str(args.start_port + i),
                   POD_IP="127.0.0.1",
                   PADDLE_TRACE_LABEL=f"server-{i}")
        env.update(_collector_env(col_ep, "server"))
        children.append(_Child(
            f"server-{i}", cmd, env,
            os.path.join(args.log_dir, f"serverlog.{i}")))
    for i in range(n_w):
        env = dict(common, TRAINING_ROLE="TRAINER",
                   PADDLE_TRAINER_ID=str(i),
                   PADDLE_CURRENT_ENDPOINT=worker_eps[i],
                   PADDLE_TRACE_LABEL=f"trainer-{i}")
        env.update(_elastic_env(args, f"trainer-{i}"))
        env.update(_collector_env(col_ep, "trainer"))
        children.append(_Child(
            f"trainer-{i}", cmd, env,
            os.path.join(args.log_dir, f"workerlog.{i}")))
    return _run_supervisor(
        args, children,
        members=[c for c in children if c.name.startswith("trainer-")],
        endpoints={f"trainer-{i}": worker_eps[i] for i in range(n_w)},
        collector=collector)


def main():
    args = _parse()
    if args.server_num > 0 or args.worker_num > 0:
        sys.exit(_launch_ps(args))
    ips = [s.strip() for s in args.ips.split(",") if s.strip()]
    sys.exit(_launch_collective(args, ips))


if __name__ == "__main__":
    main()
