"""HOPAAS core — the paper's primary contribution.

Hyperparameter OPtimization As A Service: a client/server protocol
coordinating gradient-less optimization studies across heterogeneous,
elastic compute.  The wire layer is a versioned, resource-oriented REST
surface (``repro_torch.core.api``): typed schemas validated at the boundary, a
declarative router, bearer-header auth, and paginated monitoring
endpoints — with the paper's original RPC endpoints (`ask` / `tell` /
`should_prune` / `version`, plus the batched `ask_batch` / `tell_batch`
extension) mounted as a byte-compatible v1 shim over the same core.
The service core is sharded per study (see ``server.StudyContext``):
requests for different studies never contend on a common lock.

This is the PyTorch port: the TPE and GP samplers compute on a torch
device through hand-written CUDA kernels.  The multi-process shard
fabric and replication are not ported yet.
"""
from .api import ApiError, Route, Router, build_openapi, build_router
from .auth import AuthError, TokenManager
from .client import (Client, HopaasError, RetryPolicy, Study as ClientStudy,
                     Trial as ClientTrial, suggestions)
from .obs_cache import ObservationCache
from .campaign import CampaignResult, run_campaign
from .pruners import known_pruners, make_pruner
from .report import convergence_trace, format_report, study_summary
from .samplers import known_samplers, make_sampler
from .server import HOPAAS_VERSION, HopaasServer, StudyContext
from .space import Param, SearchSpace
from .durable import DurableStorage, FsyncMode, WalDirectoryLockedError
from .faults import FaultInjector
from .storage import CorruptJournalError, InMemoryStorage, JournalStorage
from .transport import (DirectTransport, HttpServiceRunner, HttpTransport,
                        PooledHttpTransport, RoundRobinTransport,
                        Transport)
from .types import Direction, Study, StudyConfig, Trial, TrialState

__all__ = [
    "ApiError", "Route", "Router", "build_openapi", "build_router",
    "AuthError", "TokenManager", "Client", "HopaasError", "RetryPolicy",
    "ClientStudy", "ClientTrial", "suggestions", "CampaignResult",
    "run_campaign", "make_pruner", "known_pruners", "convergence_trace",
    "format_report", "study_summary", "make_sampler", "known_samplers",
    "HOPAAS_VERSION", "HopaasServer", "StudyContext",
    "ObservationCache", "Param", "SearchSpace",
    "CorruptJournalError", "DurableStorage", "FsyncMode",
    "WalDirectoryLockedError", "FaultInjector", "InMemoryStorage",
    "JournalStorage", "DirectTransport",
    "HttpServiceRunner", "HttpTransport", "PooledHttpTransport",
    "RoundRobinTransport", "Transport",
    "Direction", "Study", "StudyConfig", "Trial", "TrialState",
]
