"""Multi-profile serving, windowed and continuous: scheduler, slot state,
page pools, profile cache, engine."""
from repro_torch.serve.engine import ServeEngine  # noqa: F401
from repro_torch.serve.profile_cache import ProfileCache  # noqa: F401
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: F401
from repro_torch.serve.slots import SlotState, SlotSync  # noqa: F401
