"""--arch config module (see registry.py for the dimension table and source citation)."""

from repro_torch.configs.registry import OLMO_1B as CONFIG
from repro_torch.configs.registry import smoke as _smoke

SMOKE = _smoke(CONFIG.name)
