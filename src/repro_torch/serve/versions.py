"""Versioned artifact store: publish -> pinned reads -> retention GC.

The paper's one-pass method makes a fitted kernel-clustering model a
small, cheap-to-hold artifact, so a deployment keeps MANY of them: every
refit publishes a new immutable version and serving picks one (usually
the latest) to hot-swap in. This module is that store:

    <root>/v_1/            one full artifact dir per version
    <root>/v_2/               (spec.json + leaves.json + step_0/ — the
    <root>/v_3/                serve/artifact.py format, unchanged)
    <root>/v_4.<pid>.tmp/  a publish in flight (never read)
    <root>/v_2.pins/<owner>  one file per owner serving v_2

The layout, the commit protocol and the pin files are the JAX package's
(repro.serve.versions), and the artifacts load in either package, so a
store written by one is read, pinned and GC'd by the other.

Commit protocol mirrors the checkpoint layer (distributed/checkpoint.py):
a publish writes the complete artifact into a writer-unique
`v_<N>.<pid>.tmp` and os.replace()s it to `v_<N>`, so a reader never
observes a half-written version — a version directory either does not
exist or is complete. Readers additionally require spec.json (written
last inside the tmp dir) before counting a directory as a version,
mirroring `latest_step`'s manifest.json guard. Concurrent publishers are
safe: the commit rename refuses to land on an existing (non-empty)
directory, so a publisher that lost the number-allocation race — or hit
leftover junk at its target — bumps to the next free number rather than
replacing a committed version.

Retention is keep-last-K, same policy as CheckpointManager._gc: `gc(keep)`
removes all but the K highest version numbers, plus .tmp dirs from
CRASHED publishes only (stale by more than _TMP_TTL_S; a live publish
takes seconds, so a concurrent writer's in-flight tmp is never swept).
Version numbers are monotonic and never reused within a store's life —
GC removes directories, not the counter, because `latest()` scans
surviving dirs and publish allocates past them.

Pins are the serving tier's guard on top: a worker that loaded
`v_<N>` records `pin(N, owner)` — one file per owner under
`<root>/v_<N>.pins/` — and gc() NEVER removes a version any owner still
pins, however old, so a worker lagging a rollout can't have its serving
artifact deleted out from under a rollback. `unpin` releases
the refcount; pin dirs of fully-unpinned, already-GC'ed versions are
swept by the next gc().

ModelRegistry (serve/registry.py) layers the serving side on top:
`registry.load_version(name, root)` for pinned/latest reads and
`registry.swap(name, store.load())` for the warm hot-swap. Loads land
on the card unless the caller passes device="cpu".
"""
from __future__ import annotations

import os
import pathlib
import re
import shutil
import time
from typing import List, Optional

from repro_torch.serve.artifact import FittedModel, load_model, save_model

_VERSION_RE = re.compile(r"^v_(\d+)$")
# A .tmp dir older than this is a crashed publish (a live one finishes in
# seconds); gc() only sweeps these, never a concurrent in-flight write.
_TMP_TTL_S = 3600.0


class VersionStore:
    """Keep-last-K store of immutable FittedModel versions under one root.

    keep=None (the default) disables automatic GC; a keep passed to the
    constructor applies to every publish, a keep passed to publish()
    overrides it for that call.
    """

    def __init__(self, root: str, keep: Optional[int] = None):
        self.root = pathlib.Path(root)
        self.keep = keep

    def versions(self) -> List[int]:
        """Committed version numbers, ascending ([] for an empty/new
        store). In-flight .tmp publishes and spec-less directories (a
        crashed pre-atomic-rename state that cannot exist under the
        commit protocol, but cheap to guard) are not versions."""
        if not self.root.exists():
            return []
        out = []
        for p in self.root.iterdir():
            m = _VERSION_RE.match(p.name)
            if m and p.is_dir() and (p / "spec.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    def path(self, version: Optional[int] = None) -> str:
        """Artifact directory of `version` (default: latest). Raises
        FileNotFoundError for a missing/GC'ed version — a pinned reader
        finds out loudly, not via a stale-shape restore error."""
        version = version if version is not None else self.latest()
        if version is None:
            raise FileNotFoundError(f"no versions under {self.root}")
        p = self.root / f"v_{version}"
        if not (p / "spec.json").exists():
            raise FileNotFoundError(
                f"no version {version} under {self.root} "
                f"(have {self.versions()}; GC'ed or never published)")
        return str(p)

    def publish(self, model: FittedModel, keep: Optional[int] = None) -> int:
        """Commit `model` as the next version; returns its number.

        Atomic: the artifact is fully written into a writer-unique
        v_<N>.<pid>.tmp and renamed into place, so a concurrent reader
        sees either the old latest or the complete new version, never a
        partial one. The rename fails on an existing non-empty target,
        so losing a number-allocation race against another publisher
        means taking the next number — never replacing a committed
        version another publisher already handed out.
        """
        self.root.mkdir(parents=True, exist_ok=True)
        vs = self.versions()
        version = vs[-1] + 1 if vs else 1
        tmp = self.root / f"v_{version}.{os.getpid()}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        save_model(model, str(tmp))
        while True:
            try:
                os.replace(tmp, self.root / f"v_{version}")
                break
            except OSError:
                version += 1                    # target taken: next number
        keep = keep if keep is not None else self.keep
        if keep is not None:
            self.gc(keep)
        return version

    def load(self, version: Optional[int] = None,
             device="cuda") -> FittedModel:
        """Load a pinned `version`, or the latest when None, onto
        `device`."""
        return load_model(self.path(version), device=device)

    # -- pin refcounts (serving workers vs GC) ---------------------------

    def _pin_dir(self, version: int) -> pathlib.Path:
        # ".pins" does not match _VERSION_RE and does not end in ".tmp",
        # so pin dirs are invisible to versions() and the tmp sweep.
        return self.root / f"v_{int(version)}.pins"

    def pin(self, version: int, owner: str) -> int:
        """Record that `owner` (e.g. a serving worker's id) serves
        `version`.

        One file per owner — refcount by directory listing, so pins from
        separate worker processes compose without any shared lock.
        Idempotent per (version, owner). Raises FileNotFoundError for a
        version that does not exist (nothing to protect). Returns the
        version pinned (convenient for `pin(store.latest(), ...)`)."""
        version = int(version)
        self.path(version)                      # loud on missing version
        d = self._pin_dir(version)
        d.mkdir(parents=True, exist_ok=True)
        (d / str(owner)).touch()
        return version

    def unpin(self, version: int, owner: str) -> None:
        """Release `owner`'s pin on `version`; idempotent (a worker may
        unpin during teardown after GC already swept the pin dir)."""
        try:
            (self._pin_dir(int(version)) / str(owner)).unlink()
        except FileNotFoundError:
            pass

    def pins(self, version: int) -> List[str]:
        """Owners currently pinning `version` (sorted; [] when none)."""
        d = self._pin_dir(int(version))
        if not d.is_dir():
            return []
        return sorted(p.name for p in d.iterdir())

    def gc(self, keep: Optional[int] = None) -> List[int]:
        """Keep the last `keep` versions, remove the rest (and .tmp dirs
        from CRASHED publishes — stale by > _TMP_TTL_S; an in-flight
        concurrent publish is left alone); returns the versions removed.

        A version with live pins (see pin()) is NEVER removed, whatever
        its age: a worker still serving v_2 must be able to roll back to
        it after a rollout of v_5 fails. Pin dirs of
        versions that are gone and fully unpinned are swept here too."""
        keep = keep if keep is not None else self.keep
        if keep is None or keep < 1:
            raise ValueError(f"gc needs keep >= 1, got {keep!r}")
        removed = []
        for v in self.versions()[:-keep]:
            if self.pins(v):                     # a worker still serves it
                continue
            shutil.rmtree(self.root / f"v_{v}", ignore_errors=True)
            removed.append(v)
        # Sweep pin dirs whose version is gone and whose refcount is zero
        # (a worker unpinning after GC leaves an empty dir behind).
        live = set(self.versions())
        if self.root.exists():
            for p in self.root.iterdir():
                m = re.match(r"^v_(\d+)\.pins$", p.name)
                if m and int(m.group(1)) not in live and not self.pins(
                        int(m.group(1))):
                    shutil.rmtree(p, ignore_errors=True)
        if self.root.exists():
            now = time.time()
            for p in self.root.iterdir():
                if p.is_dir() and p.name.endswith(".tmp"):
                    try:
                        stale = now - p.stat().st_mtime > _TMP_TTL_S
                    except OSError:              # swept concurrently
                        continue
                    if stale:
                        shutil.rmtree(p, ignore_errors=True)
        return removed


# -- module-level conveniences (one-shot callers, CLI) ----------------------

def publish_version(root: str, model: FittedModel,
                    keep: Optional[int] = None) -> int:
    """Publish `model` as the next version under `root`; see VersionStore."""
    return VersionStore(root).publish(model, keep=keep)


def latest_version(root: str) -> Optional[int]:
    return VersionStore(root).latest()


def load_version(root: str, version: Optional[int] = None,
                 device="cuda") -> FittedModel:
    """Pinned (or latest, when version=None) read from the store."""
    return VersionStore(root).load(version, device=device)


def gc_versions(root: str, keep: int) -> List[int]:
    """Keep-last-`keep` retention sweep; returns the versions removed."""
    return VersionStore(root).gc(keep)
