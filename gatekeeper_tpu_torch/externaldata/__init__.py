# Copied from gatekeeper_tpu/externaldata/__init__.py for the PyTorch port.
"""External-data provider subsystem.

Two-phase design: host-side *key collection + batched prefetch* (one
round per provider, single-flight, TTL-cached, circuit-broken) feeding
device-resident provider tables, so the evaluation kernel performs only
gathers.  See README "External data".
"""

from gatekeeper_tpu_torch.externaldata.breaker import (CLOSED, HALF_OPEN,
                                                       OPEN, CircuitBreaker)
from gatekeeper_tpu_torch.externaldata.cache import (ERROR_TTL_CAP_S,
                                                     Outcome, TTLCache)
from gatekeeper_tpu_torch.externaldata.client import (BreakerOpenError,
                                                      FetchError,
                                                      ProviderClient)
from gatekeeper_tpu_torch.externaldata.fake import (FakeProvider,
                                                    clear_fakes,
                                                    fake_transport,
                                                    get_fake, register_fake)
from gatekeeper_tpu_torch.externaldata.runtime import (ExternalDataRuntime,
                                                       get_runtime,
                                                       set_runtime)

__all__ = [
    "CLOSED", "HALF_OPEN", "OPEN", "CircuitBreaker",
    "ERROR_TTL_CAP_S", "Outcome", "TTLCache",
    "BreakerOpenError", "FetchError", "ProviderClient",
    "FakeProvider", "clear_fakes", "fake_transport", "get_fake",
    "register_fake",
    "ExternalDataRuntime", "get_runtime", "set_runtime",
]
