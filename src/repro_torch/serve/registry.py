"""Versioned models by name: the part of the reference's model registry that
the session front door needs.

``PREDICT(model=...)`` references resolve through one documented path,
:meth:`ModelRegistry.resolve`:

    ``"name"``          the live version (what production traffic gets)
    ``"name@2"``        that exact published version
    ``"name@latest"``   the newest published version
    ``"name@live"``     explicit spelling of the default

The registry implements the mapping protocol the SQL frontend reads
(``in`` / ``[]`` / iteration / ``len``), so ``models[spec.model]`` returns
the resolved version's pipeline and raises the precise
:class:`~repro_torch.errors.UnknownModelVersionError` instead of a generic
miss. The first version of a name goes live when it is published; later
versions are staged. The lifecycle beyond that (shadow, split, cutover,
rollback, retire, ``name@shadow``, warm compiles onto served routes and the
journal) comes with serving and persistence: each of those raises
``NotImplementedError`` naming ROADMAP Queue 1 item 7.
"""
from __future__ import annotations

import threading
from typing import Any, Optional

from repro_torch.errors import UnknownModelError, UnknownModelVersionError

LIFECYCLE_NOT_PORTED = (
    "the model lifecycle (shadow/split/cutover/rollback/retire) is not ported "
    "yet: ROADMAP.md Queue 1 item 7, persistence and lifecycle"
)


class ModelVersion:
    """One published version of a named model: pipeline + fingerprint +
    lifecycle state. Returned by :meth:`ModelRegistry.publish`."""

    def __init__(self, name: str, version: int, pipeline, fingerprint: str):
        self.name = name
        self.version = version
        self.pipeline = pipeline
        self.fingerprint = fingerprint
        self.state = "published"
        self.history: list[str] = ["published"]

    @property
    def ref(self) -> str:
        """The canonical ``name@version`` reference for this version."""
        return f"{self.name}@{self.version}"

    def _go_live(self) -> None:
        self.state = "live"
        self.history.append("live")

    def __repr__(self) -> str:
        return (
            f"ModelVersion({self.ref}, state={self.state!r}, "
            f"fingerprint={self.fingerprint[:12]}…)"
        )


class ModelRegistry:
    """Names → ordered published versions, under one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._versions: dict[str, list[ModelVersion]] = {}
        self._live: dict[str, int] = {}
        self._pins: list[Any] = []  # identity-hashed pipeline components

    # -- publish -------------------------------------------------------------

    def publish(self, name: str, pipe_or_path) -> ModelVersion:
        """Publish a pipeline (or saved-pipeline path) as the next version
        of ``name``; returns the :class:`ModelVersion` handle. The first
        version of a name goes live immediately; later versions are staged
        (``name@N`` / ``name@latest`` reach them, ``name`` keeps the live
        one)."""
        if isinstance(pipe_or_path, str):
            from repro_torch.ml.pipeline import load_pipeline

            pipe_or_path = load_pipeline(pipe_or_path)
        from repro_torch.core.fingerprint import fingerprint

        with self._lock:
            versions = self._versions.setdefault(name, [])
            number = len(versions) + 1
            fp = fingerprint(
                "model-version", name, number, pipe_or_path, pins=self._pins
            )
            mv = ModelVersion(name, number, pipe_or_path, fp)
            versions.append(mv)
            if number == 1:
                mv._go_live()
                self._live[name] = 1
            return mv

    # -- lifecycle: not ported yet -------------------------------------------

    def shadow(self, name: str, version: Optional[int]) -> None:
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def split(self, name: str, fractions: dict[int, float]) -> None:
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def cutover(self, name: str, version: int, **kw) -> None:
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def rollback(self, name: str, **kw) -> None:
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    def retire(self, name: str, version: int) -> None:
        raise NotImplementedError(LIFECYCLE_NOT_PORTED)

    # -- resolution (the one documented path) --------------------------------

    def _parse_ref(self, ref: str) -> tuple[str, Optional[str]]:
        name, sep, selector = str(ref).partition("@")
        return name, (selector if sep else None)

    def _get_version(self, name: str, version: int) -> ModelVersion:
        with self._lock:
            versions = self._versions.get(name)
            if versions is None:
                raise UnknownModelError(
                    f"unknown model '{name}' — registered models: "
                    f"{sorted(self._versions) or '(none)'}"
                )
            if not 1 <= version <= len(versions):
                raise UnknownModelVersionError(
                    f"model '{name}' has no version {version} — published: "
                    f"1..{len(versions)}"
                )
            return versions[version - 1]

    def resolve(self, ref: str) -> ModelVersion:
        """Resolve a model reference to a :class:`ModelVersion`:
        ``"name"`` / ``"name@live"`` → the live version; ``"name@2"`` →
        that exact version; ``"name@latest"`` → the newest published.
        ``"name@shadow"`` raises ``NotImplementedError`` (item 7)."""
        name, selector = self._parse_ref(ref)
        with self._lock:
            if name not in self._versions:
                raise UnknownModelError(
                    f"unknown model '{name}' — registered models: "
                    f"{sorted(self._versions) or '(none)'}"
                )
            if selector is None or selector == "live":
                return self._get_version(name, self._live[name])
            if selector == "latest":
                return self._get_version(name, len(self._versions[name]))
            if selector == "shadow":
                raise NotImplementedError(LIFECYCLE_NOT_PORTED)
            if selector.isdigit():
                return self._get_version(name, int(selector))
            raise UnknownModelVersionError(
                f"malformed model reference {ref!r} — use 'name', 'name@N', "
                f"'name@latest', 'name@live', or 'name@shadow'"
            )

    # -- the mapping protocol the SQL frontend uses --------------------------

    def __contains__(self, ref) -> bool:
        name, _ = self._parse_ref(ref)
        with self._lock:
            return name in self._versions

    def __getitem__(self, ref):
        """The resolved version's *pipeline* (what ``build_prediction_query``
        embeds in the IR) — precise typed errors instead of KeyError."""
        return self.resolve(ref).pipeline

    def __iter__(self):
        with self._lock:
            return iter(sorted(self._versions))

    def __len__(self) -> int:
        with self._lock:
            return len(self._versions)

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict[str, Any]:
        """Registry state for ``db.cache_stats()['models']``, in the
        reference's shape: per model the live pointer (shadow, split, routes
        and rollbacks stay empty until item 7) and every version's state and
        recorded history."""
        with self._lock:
            return {
                name: {
                    "live": self._live.get(name),
                    "shadow": None,
                    "split": {},
                    "routes": [],
                    "rollbacks": [],
                    "versions": [
                        {
                            "version": mv.version,
                            "state": mv.state,
                            "history": list(mv.history),
                            "events": [],
                            "fingerprint": mv.fingerprint,
                            "error": None,
                        }
                        for mv in versions
                    ],
                }
                for name, versions in self._versions.items()
            }
