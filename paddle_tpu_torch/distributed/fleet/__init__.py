"""Fleet, the distributed-training facade, in collective mode (port of
paddle_tpu/distributed/fleet/__init__.py).

``fleet.init(is_collective=True, strategy=...)`` compiles the strategy
(``strategy_compiler.py``), starts the process group and installs the
strategy's mesh (``distributed.init_parallel_env``), and keeps the role
maker and the ``HybridCommunicateGroup``.  ``distributed_optimizer``
wraps the user's optimizer (swapped for Lamb or LarsMomentum where the
strategy says so); ``train_step`` builds the step the strategy
compiles to: ``ShardedTrainStep`` over ``dp``, ``sharding`` and ``mp``
(``mp_degree``) by default, the ``dp_meta`` steps for LocalSGD, DGC and
fp16_allreduce.
``distributed_model`` wraps a layer in ``DataParallel``.  ``metrics`` and
``utils`` (``recompute``) are the reference's modules.

The parameter-server lifecycle: ``init_worker`` connects a trainer to the
shards of ``PADDLE_PSERVERS_IP_PORT_LIST`` (``ps_client()``) and starts
its heartbeat, ``stop_worker`` says bye; ``init_server`` builds this
rank's shard (``ps.service.PsServer``) and ``run_server`` serves it until
every worker has said bye.  A server role (``TRAINING_ROLE=PSERVER``)
keeps to the host, as the reference's whose ``init`` joins nothing across
processes: its ``init`` starts no process group and installs no mesh, so
it never touches a card.  The inference and persistable savers raise,
as the reference's, naming the port's ``jit.save`` and ``save``;
``fleet.utils.fs`` holds the file systems.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from paddle_tpu_torch.distributed.fleet.role_maker import (
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker)
from paddle_tpu_torch.distributed.fleet.strategy import DistributedStrategy
from paddle_tpu_torch.distributed.fleet.strategy_compiler import (
    CompiledStrategy, compile_strategy, maybe_swap_optimizer)
from paddle_tpu_torch.distributed.fleet.topology import (
    CommunicateTopology, HybridCommunicateGroup)
from paddle_tpu_torch.parallel.mesh import in_loopback, set_mesh

__all__ = ["init", "is_first_worker", "worker_index", "worker_num",
           "worker_endpoints", "server_num", "server_index",
           "server_endpoints", "is_server", "is_worker", "barrier_worker",
           "distributed_optimizer", "distributed_model", "train_step",
           "applied_meta_list", "get_hybrid_communicate_group",
           "DistributedStrategy", "DistributedOptimizer",
           "PaddleCloudRoleMaker", "UserDefinedRoleMaker", "Role",
           "CommunicateTopology", "HybridCommunicateGroup", "stop_worker",
           "init_worker", "ps_client", "init_server", "run_server",
           "save_inference_model", "save_persistables", "metrics", "utils",
           "recompute"]


class _FleetState:
    def __init__(self):
        self.role_maker: Optional[RoleMakerBase] = None
        self.strategy: Optional[DistributedStrategy] = None
        self.compiled: Optional[CompiledStrategy] = None
        self.user_optimizer = None
        self.hcg: Optional[HybridCommunicateGroup] = None
        self.initialized = False
        self.ps_client = None
        self.ps_server = None


_GLOBAL = _FleetState()
_LOCAL = threading.local()


def _st() -> _FleetState:
    """This rank's fleet: the process's, or a ``LoopbackWorld`` rank's."""
    if not in_loopback():
        return _GLOBAL
    if not hasattr(_LOCAL, "state"):
        _LOCAL.state = _FleetState()
    return _LOCAL.state


def _compile(strategy: DistributedStrategy):
    _state = _st()
    _state.strategy = strategy
    _state.compiled = compile_strategy(strategy)
    set_mesh(_state.compiled.mesh)
    _state.hcg = HybridCommunicateGroup(mesh=_state.compiled.mesh)


def init(role_maker: Optional[RoleMakerBase] = None,
         is_collective: bool = False,
         strategy: Optional[DistributedStrategy] = None, device=None):
    """fleet.init (reference fleet_base.py:130): the process group (NCCL,
    or gloo for ``device="cpu"``) from the ``PADDLE_*`` environment, then
    the strategy's mesh.  A parameter server's role starts neither."""
    from paddle_tpu_torch.distributed.parallel import init_parallel_env
    _state = _st()
    if role_maker is None and not is_collective:
        role_maker = PaddleCloudRoleMaker()
    if role_maker is not None and role_maker.is_server():
        _state.role_maker = role_maker
        _state.strategy = strategy or DistributedStrategy()
        _state.compiled = _state.hcg = None
    else:
        init_parallel_env(device=device)
        _state.role_maker = role_maker or PaddleCloudRoleMaker(
            is_collective=is_collective)
        _compile(strategy or DistributedStrategy())
    _state.user_optimizer = None
    _state.initialized = True


def _require_init() -> _FleetState:
    if not _st().initialized:
        init()
    return _st()


def is_first_worker() -> bool:
    return _require_init().role_maker.is_first_worker()


def worker_index() -> int:
    return _require_init().role_maker.worker_index()


def worker_num() -> int:
    return _require_init().role_maker.worker_num()


def worker_endpoints(to_string=False):
    eps = _require_init().role_maker.get_trainer_endpoints()
    return ",".join(eps) if to_string else eps


def server_num() -> int:
    return _require_init().role_maker.server_num()


def server_index() -> int:
    return _require_init().role_maker.server_index()


def server_endpoints(to_string=False):
    eps = _require_init().role_maker.get_pserver_endpoints()
    return ",".join(eps) if to_string else eps


def is_server() -> bool:
    return _require_init().role_maker.is_server()


def is_worker() -> bool:
    return _require_init().role_maker.is_worker()


def barrier_worker():
    _require_init().role_maker.barrier_worker()


def init_worker():
    """Connect this trainer to the PS shards of
    ``PADDLE_PSERVERS_IP_PORT_LIST`` and start its heartbeat; the client
    is ``ps_client()``."""
    _state = _require_init()
    from paddle_tpu_torch.distributed.ps.service import PsClient
    eps = _state.role_maker.get_pserver_endpoints()
    if not eps:
        raise RuntimeError("init_worker: PADDLE_PSERVERS_IP_PORT_LIST empty")
    _state.ps_client = PsClient(
        eps, worker_id=f"trainer-{_state.role_maker.worker_index()}")
    _state.ps_client.start_heartbeat()


def ps_client():
    c = _require_init().ps_client
    if c is None:
        raise RuntimeError("call fleet.init_worker() first")
    return c


def init_server(tables=None, **kwargs):
    """Build this rank's PS shard on its endpoint of
    ``PADDLE_PSERVERS_IP_PORT_LIST`` (127.0.0.1, any port, without one).
    ``tables``: {name: a host table, or (rows, dim[, optimizer, lr])};
    ``kwargs`` go to ``PsServer``."""
    _state = _require_init()
    from paddle_tpu_torch.distributed.ps import HostEmbeddingTable
    from paddle_tpu_torch.distributed.ps.service import PsServer
    built = {name: t if isinstance(t, HostEmbeddingTable)
             else HostEmbeddingTable(*t)
             for name, t in (tables or {}).items()}
    eps = _state.role_maker.get_pserver_endpoints()
    idx = _state.role_maker.server_index()
    host, port = (eps[idx].rsplit(":", 1) if eps else ("127.0.0.1", "0"))
    _state.ps_server = PsServer(
        built, host=host, port=int(port),
        n_workers=_state.role_maker.worker_num(), **kwargs)
    return _state.ps_server


def run_server():
    """Serve until every worker has said bye, or a shutdown."""
    srv = _require_init().ps_server
    if srv is None:
        raise RuntimeError("call fleet.init_server() first")
    srv.serve_forever()


def stop_worker():
    _state = _require_init()
    if _state.ps_client is not None:
        _state.ps_client.bye()
        _state.ps_client = None


def save_inference_model(executor=None, dirname=None, *args, **kwargs):
    """Raises, as the reference's (``fleet/__init__.py:265-268``): the
    export is ``jit.save``."""
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.save for inference export")


def save_persistables(executor=None, dirname=None, main_program=None,
                      **kwargs):
    """Raises, as the reference's (``fleet/__init__.py:271-272``): save
    the state dict, or a TrainStep with ``distributed.checkpoint``."""
    raise NotImplementedError(
        "use paddle_tpu_torch.save(model.state_dict(), ...)")


class DistributedOptimizer:
    """What fleet.distributed_optimizer returns: the optimizer API
    delegated to the inner optimizer, with the strategy (reference
    fleet_base.py:610)."""

    def __init__(self, optimizer, strategy: DistributedStrategy,
                 compiled: CompiledStrategy):
        self._inner = maybe_swap_optimizer(optimizer, compiled)
        self.user_defined_strategy = strategy
        self._compiled = compiled

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner_opt(self):
        return self._inner

    def step(self):
        return self._inner.step()

    def clear_grad(self, *a, **k):
        return self._inner.clear_grad(*a, **k)

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        return self._inner.minimize(loss, startup_program, parameters,
                                    no_grad_set)


def distributed_optimizer(optimizer, strategy: Optional[DistributedStrategy]
                          = None) -> DistributedOptimizer:
    _state = _require_init()
    if strategy is not None:
        _compile(strategy)
    opt = DistributedOptimizer(optimizer, _state.strategy, _state.compiled)
    _state.user_optimizer = opt
    return opt


def distributed_model(model):
    """The model wrapped in ``DataParallel`` (reference fleet_base
    distributed_model)."""
    _require_init()
    from paddle_tpu_torch.distributed.parallel import DataParallel
    return DataParallel(model)


def train_step(model, loss_fn: Callable, optimizer=None, **overrides):
    """The step the active strategy compiles to (the runtime form of the
    reference's minimize() chain, fleet_base.py:1090).  A ``DataParallel``
    model trains as the layer it wraps."""
    _state = _require_init()
    from paddle_tpu_torch.distributed.parallel import DataParallel
    opt = optimizer or (_state.user_optimizer._inner
                        if _state.user_optimizer else None)
    if opt is None:
        raise ValueError("pass an optimizer or call "
                         "fleet.distributed_optimizer first")
    if isinstance(opt, DistributedOptimizer):
        opt = opt._inner
    if isinstance(model, DataParallel):
        model = model._layers
    return _state.compiled.train_step(model, loss_fn, opt, **overrides)


def applied_meta_list():
    """The meta-optimizers the strategy fired (the reference's
    compile-only test tier reads them)."""
    return list(_require_init().compiled.applied_meta_list)


def get_hybrid_communicate_group() -> HybridCommunicateGroup:
    return _require_init().hcg


from paddle_tpu_torch.distributed.fleet import metrics  # noqa: F401,E402
from paddle_tpu_torch.distributed.fleet import utils  # noqa: F401,E402
from paddle_tpu_torch.distributed.fleet.utils import recompute  # noqa: F401,E402,E501
from paddle_tpu_torch.distributed.fleet.utils import fs  # noqa: F401,E402
