"""Plugin registry — the Python face of ErasureCodePluginRegistry.

Twin of ceph_tpu/ec/registry.py: plugins are Python factories
registered by name, and profiles stay string-maps so reference
profiles work verbatim. `factory(profile, device=None)` builds the
coder on the CUDA device unless the caller passes a device; without
CUDA and without a device it raises.
"""

from __future__ import annotations

from typing import Callable, Mapping

from .interface import (ErasureCode, ErasureCodeProfile, profile_from_string,
                        resolve_device)

_REGISTRY: dict[str, Callable[..., ErasureCode]] = {}


def register(name: str):
    """Decorator: register an ErasureCode subclass (or factory) as a
    plugin. It is called as fac(profile, device=...)."""
    def deco(fac):
        _REGISTRY[name] = fac
        return fac
    return deco


def plugins() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # "preload": import the bundled plugin modules so they self-register;
    # a broken plugin surfaces as its import error
    from . import clay as _clay  # noqa: F401
    from . import lrc as _lrc  # noqa: F401
    from . import rs as _rs  # noqa: F401
    from . import shec as _shec  # noqa: F401


def get_factory(name: str):
    """Look up a registered plugin factory by name. Raises ValueError
    for unknown plugins."""
    _ensure_loaded()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown EC plugin {name!r}; known: {sorted(_REGISTRY)}") from None


def factory(profile: Mapping[str, str] | str, device=None) -> ErasureCode:
    """Instantiate a coder from a profile (dict or profile string) on
    `device` (None: the CUDA device, raising when there is none).

    The plugin name comes from profile['plugin'] (default 'tpu_rs', the
    jerasure-equivalent RS coder).
    """
    if isinstance(profile, str):
        profile = profile_from_string(profile)
    prof: ErasureCodeProfile = dict(profile)
    device = resolve_device(device)
    return get_factory(prof.get("plugin", "tpu_rs"))(prof, device=device)
