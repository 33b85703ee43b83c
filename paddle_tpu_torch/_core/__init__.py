from . import flags, random  # noqa: F401
from .device import resolve_device  # noqa: F401
from .flags import flag, get_flags, set_flags  # noqa: F401
