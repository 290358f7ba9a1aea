"""Role makers (port of paddle_tpu/distributed/fleet/role_maker.py).

Roles come from the ``PADDLE_*`` launch protocol (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_TRAINERS_NUM``, and for the
parameter-server roles ``TRAINING_ROLE``, ``PADDLE_PSERVER_ID``,
``PADDLE_PSERVERS_IP_PORT_LIST``), or from this rank of the world where
they are unset.  ``refresh()`` re-reads the environment;
``refresh(store=...)`` takes the world from an elastic rendezvous store's
live member list (``distributed/elastic.py``).  ``barrier_worker`` is the collective
``barrier`` over the world.
"""
from __future__ import annotations

import os
from enum import IntEnum
from typing import List, Optional

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]


def _rank() -> int:
    from paddle_tpu_torch.distributed.collective import get_rank
    return get_rank()


class Role(IntEnum):
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class RoleMakerBase:
    def __init__(self):
        self._role = Role.WORKER
        self._current_id = 0
        self._worker_endpoints: List[str] = []
        self._server_endpoints: List[str] = []

    def is_worker(self) -> bool:
        return self._role == Role.WORKER

    def is_server(self) -> bool:
        return self._role == Role.SERVER

    def is_first_worker(self) -> bool:
        return self.is_worker() and self._current_id == 0

    def worker_index(self) -> int:
        return self._current_id

    def server_index(self) -> int:
        return self._current_id

    def worker_num(self) -> int:
        return max(1, len(self._worker_endpoints))

    def server_num(self) -> int:
        return len(self._server_endpoints)

    def get_trainer_endpoints(self) -> List[str]:
        return self._worker_endpoints

    def get_pserver_endpoints(self) -> List[str]:
        return self._server_endpoints

    def _barrier(self, comm_world=None):
        from paddle_tpu_torch.distributed.collective import barrier
        barrier()

    barrier_worker = _barrier
    barrier_all = _barrier


class PaddleCloudRoleMaker(RoleMakerBase):
    """Env-protocol role maker (reference ``PaddleCloudRoleMaker``)."""

    def __init__(self, is_collective: bool = False, **kwargs):
        super().__init__()
        self._is_collective = is_collective
        self._elastic_epoch: Optional[int] = None
        self._elastic_worker_id: Optional[str] = None
        self._read_env()

    def _read_env(self):
        """One environment snapshot (``refresh`` re-runs it)."""
        if self._is_collective:
            self._current_id = int(os.getenv("PADDLE_TRAINER_ID",
                                             str(_rank())))
            eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = eps.split(",") if eps else []
            self._role = Role.WORKER
        else:
            training_role = os.getenv("TRAINING_ROLE", "TRAINER")
            if training_role == "PSERVER":
                self._role = Role.SERVER
                self._current_id = int(os.getenv("PADDLE_PSERVER_ID", "0"))
            else:
                self._role = Role.WORKER
                self._current_id = int(os.getenv("PADDLE_TRAINER_ID", "0"))
            eps = os.getenv("PADDLE_TRAINER_ENDPOINTS", "")
            self._worker_endpoints = eps.split(",") if eps else []
            seps = os.getenv("PADDLE_PSERVERS_IP_PORT_LIST", "")
            self._server_endpoints = seps.split(",") if seps else []

    def refresh(self, store=None, worker_id: Optional[str] = None):
        """Rebuild the role and the world from the current source
        (reference ``:106-141``; ``elastic.reform`` calls it on every
        membership epoch).  Without a store, re-read the ``PADDLE_*``
        environment.  With a rendezvous ``store`` the live member list is
        the world: the rank is this worker's position among the sorted
        member ids, the endpoints are the members' registrations, and
        ``worker_num`` follows the list.  Raises ``elastic.Evicted`` when
        this worker is not a member."""
        if store is None:
            self._read_env()
            return self
        wid = worker_id or self._elastic_worker_id \
            or os.getenv("PADDLE_ELASTIC_WORKER_ID")
        if wid is None:
            raise ValueError("refresh(store=...) needs worker_id (or "
                             "PADDLE_ELASTIC_WORKER_ID) to find this "
                             "worker's rank in the membership")
        epoch, members, endpoints = store.membership()
        if wid not in members:
            from paddle_tpu_torch.distributed.elastic import Evicted
            raise Evicted(
                f"worker {wid!r} is not in membership epoch {epoch} "
                f"({members}): its lease expired; re-register to rejoin")
        self._elastic_worker_id = wid
        self._elastic_epoch = epoch
        self._current_id = members.index(wid)
        self._worker_endpoints = [e if e is not None else w
                                  for w, e in zip(members, endpoints)]
        self._role = Role.WORKER
        return self

    def worker_num(self) -> int:
        if self._elastic_epoch is not None:
            # refreshed from a rendezvous store: the live member list
            # holds, not the launcher's environment block
            return RoleMakerBase.worker_num(self)
        n = os.getenv("PADDLE_TRAINERS_NUM")
        if n:
            return int(n)
        return super().worker_num()


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """Explicit roles (reference ``UserDefinedRoleMaker``)."""

    def __init__(self, is_collective: bool = False, current_id: int = 0,
                 role: Role = Role.WORKER,
                 worker_endpoints: Optional[List[str]] = None,
                 server_endpoints: Optional[List[str]] = None, **kwargs):
        RoleMakerBase.__init__(self)
        self._is_collective = is_collective
        self._elastic_epoch: Optional[int] = None
        self._elastic_worker_id: Optional[str] = None
        self._current_id = current_id
        self._role = role
        self._worker_endpoints = worker_endpoints or []
        self._server_endpoints = server_endpoints or []

    def _read_env(self):
        """Explicit roles have no env to re-read: ``refresh()`` keeps the
        user-supplied world."""

    def worker_num(self) -> int:
        # the explicit endpoint list wins over PADDLE_TRAINERS_NUM (a
        # launcher's), which serves only where no list was given
        if self._worker_endpoints:
            return RoleMakerBase.worker_num(self)
        return PaddleCloudRoleMaker.worker_num(self)
