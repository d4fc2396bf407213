"""Both packages' layers over one set of drive paths, for the port's
interop tests, with the group-commit metadata plane at its default (on)
or off (MTPU_METAPLANE=0, the per-request oracle that has every journal
on disk when a call returns); the batched data plane off.

A test module imports the `planes` fixture; each of its tests that takes
it runs once per plane. With the metadata plane on, a drive's WAL has one
owner at a time: reaching for the other package's layer closes the
current owner's WALs (drained, materialized, checkpointed) and mounts the
drives afresh in the other package, which replays what is left. A test
that reads drive files out of band settles first (every acknowledged
journal on disk); one that opens a drive itself releases the layers
first and closes that drive's WAL after."""

import contextlib

import pytest


@pytest.fixture(params=["metaplane_on", "metaplane_off"])
def planes(request, monkeypatch):
    armed = request.param == "metaplane_on"
    monkeypatch.setenv("MTPU_METAPLANE", "1" if armed else "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    p = Planes(armed)
    yield p
    p.release()


class Planes:
    """The `planes` fixture's value: one _Owners per set of drive paths."""

    def __init__(self, armed: bool):
        self.armed = armed
        self._owners: dict[tuple, _Owners] = {}

    def layers(self, paths, build_jax, build_torch) -> tuple["Layer", "Layer"]:
        """(JAX layer, port layer) over `paths`, built on first use by
        build_jax() / build_torch(); the same drives' owners each time."""
        key = tuple(str(p) for p in paths)
        owners = self._owners.get(key)
        if owners is None:
            owners = self._owners[key] = _Owners(self.armed, build_jax, build_torch)
        return Layer(owners, "jax"), Layer(owners, "torch")

    def settle(self) -> None:
        """Every acknowledged journal on disk (before files are read or
        damaged out of band)."""
        for owners in self._owners.values():
            owners.settle()

    def release(self) -> None:
        """Close every layer's WALs; the next call of a layer mounts its
        drives afresh."""
        for owners in self._owners.values():
            owners.release()

    @contextlib.contextmanager
    def drive(self, make, path):
        """A drive of its own at `path` (make(path)), with the layers
        released first and its WAL closed after."""
        self.release()
        d = make(path)
        try:
            yield d
        finally:
            d.close_wal()


class _Owners:
    def __init__(self, armed: bool, build_jax, build_torch):
        self.armed = armed
        self.build = {"jax": build_jax, "torch": build_torch}
        self.layers: dict = {}
        self.current = None

    def take(self, pkg: str):
        if self.armed and self.current not in (None, pkg):
            _close(self.layers.pop(self.current))
        if pkg not in self.layers:
            self.layers[pkg] = self.build[pkg]()
        self.current = pkg
        return self.layers[pkg]

    def settle(self) -> None:
        for layer in self.layers.values():
            for d in _drives(layer):
                if getattr(d, "_wal", None) is not None:
                    d._wal.flush()

    def release(self) -> None:
        for layer in self.layers.values():
            _close(layer)
        self.layers.clear()
        self.current = None


def _drives(layer) -> list:
    """The bare drives under a layer: an object layer, a set of them or
    pools of sets."""
    subs = getattr(layer, "pools", None) or getattr(layer, "sets", None)
    if subs:
        return [d for sub in subs for d in _drives(sub)]
    out = []
    for d in layer.drives:
        while True:   # peel the health and disk-ID checks
            own = getattr(d, "__dict__", {})
            inner = own.get("_inner") or own.get("inner")
            if inner is None:
                break
            d = inner
        out.append(d)
    return out


def _close(layer) -> None:
    """Stop the layer's threads and close its drives' WALs."""
    layer.close()
    for d in _drives(layer):
        d.close_wal()


class Layer:
    """One package's layer of an _Owners; every attribute reached through
    it hands the drives to that package first."""

    def __init__(self, owners: _Owners, pkg: str):
        self.__dict__.update(_owners=owners, pkg=pkg)

    def __getattr__(self, name):
        return getattr(self._owners.take(self.pkg), name)

    def __setattr__(self, name, value):
        setattr(self._owners.take(self.pkg), name, value)
