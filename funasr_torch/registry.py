"""String-keyed component registry (copy of funasr_tpu/registry.py).

The reference framework wires every component (model, encoder, decoder,
predictor, tokenizer, ...) from YAML by looking a class up in a global
dict-of-dicts and calling it with the ``*_conf`` mapping (reference
funasr/register.py:8 ``RegisterTables``).  The port keeps the same table
names so reference ``config.yaml`` files resolve identically.

Tables are created on first use, so new component kinds need no central edit.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Optional


class _Table:
    """One name -> class table (e.g. all encoders)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, cls: Any) -> None:
        self._entries[name] = cls

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries)) or "<empty>"
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: {known}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()


class RegisterTables:
    """Global registry of component tables (``model_classes``,
    ``encoder_classes``, ...), named as in the reference."""

    # Modules that register components, imported lazily on first lookup miss.
    _AUTOLOAD = (
        "funasr_torch.models",
        "funasr_torch.tokenizer",
    )

    def __init__(self):
        self._tables: Dict[str, _Table] = {}
        self._autoloaded = False

    def table(self, table_name: str) -> _Table:
        if table_name not in self._tables:
            self._tables[table_name] = _Table(table_name)
        return self._tables[table_name]

    def __getattr__(self, name: str) -> _Table:
        if name.endswith("_classes"):
            return self.table(name)
        raise AttributeError(name)

    def register(self, table_name: str, name: Optional[str] = None) -> Callable:
        """Class decorator: ``@tables.register("encoder_classes", "SANMEncoder")``."""

        def decorator(cls):
            self.table(table_name).register(name or cls.__name__, cls)
            return cls

        return decorator

    def get(self, table_name: str, name: str) -> Any:
        tab = self.table(table_name)
        if name not in tab:
            self._autoload()
        return tab.get(name)

    def build(self, table_name: str, name: str, /, **conf) -> Any:
        """Look up + construct in one call: the YAML wiring primitive."""
        return self.get(table_name, name)(**conf)

    def _autoload(self) -> None:
        if self._autoloaded:
            return
        self._autoloaded = True
        for mod in self._AUTOLOAD:
            importlib.import_module(mod)

    def summary(self) -> str:
        lines = []
        for tname in sorted(self._tables):
            tab = self._tables[tname]
            lines.append(f"{tname}:")
            for name in sorted(tab.keys()):
                lines.append(f"  {name}")
        return "\n".join(lines)


def not_ported(kind: str, name: str, what: str):
    """A registry entry for a component the port lacks: building it raises
    ``NotImplementedError`` naming it."""
    def build(*args, **kwargs):
        raise NotImplementedError(f"{kind} {name!r} ({what}) is not ported to funasr_torch "
                                  "(ROADMAP.md Queue 1)")
    build.__name__ = name
    return build


tables = RegisterTables()
