"""Torch-style Table: a heterogeneous, 1-indexed keyed container
(counterpart of bigdl_tpu/utils/table.py; ref utils/Table.scala:35).

The optimizers keep their config and state in one, under the reference's
keys (learningRate, momentum, dampening, weightDecay, nesterov, neval,
epoch, loss, evalCounter, ...).
"""
from __future__ import annotations


class Table:
    """Keyed container.  Integer keys are 1-based, matching Torch/BigDL."""

    def __init__(self, *args, **kwargs):
        self._store = {}
        for i, v in enumerate(args):
            self._store[i + 1] = v
        for k, v in kwargs.items():
            self._store[k] = v

    # -- mapping interface ------------------------------------------------
    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value):
        self._store[key] = value

    def __delitem__(self, key):
        del self._store[key]

    def __contains__(self, key):
        return key in self._store

    def get(self, key, default=None):
        return self._store.get(key, default)

    def get_or_update(self, key, default):
        if key not in self._store:
            self._store[key] = default
        return self._store[key]

    def keys(self):
        return self._store.keys()

    def values(self):
        return self._store.values()

    def items(self):
        return self._store.items()

    def __len__(self):
        return len(self._store)

    def __iter__(self):
        # array-part values in order (1..n), like Torch ipairs
        i = 1
        while i in self._store:
            yield self._store[i]
            i += 1

    def length(self):
        """Length of the contiguous 1-based array part."""
        i = 1
        while i in self._store:
            i += 1
        return i - 1

    # -- array-part mutation (Table.scala insert/remove) ------------------
    def insert(self, *args):
        if len(args) == 1:
            self._store[self.length() + 1] = args[0]
        else:
            pos, value = args
            for i in range(self.length(), pos - 1, -1):
                self._store[i + 1] = self._store[i]
            self._store[pos] = value
        return self

    def remove(self, pos=None):
        n = self.length()
        if n == 0:
            return None
        if pos is None:
            pos = n
        value = self._store.get(pos)
        for i in range(pos, n):
            self._store[i] = self._store[i + 1]
        del self._store[n]
        return value

    # -- misc -------------------------------------------------------------
    def update(self, other):
        if isinstance(other, Table):
            other = other._store
        self._store.update(other)
        return self

    def copy(self):
        t = Table()
        t._store = dict(self._store)
        return t

    def clear(self):
        self._store.clear()
        return self

    def __eq__(self, other):
        if isinstance(other, Table):
            return self._store == other._store
        return NotImplemented

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in sorted(
            self._store.items(),
            key=lambda kv: (isinstance(kv[0], str), str(kv[0]))))
        return f"Table({{{inner}}})"


def T(*args, **kwargs):
    """Builder matching the reference's ``T(...)`` (Table.scala companion)."""
    return Table(*args, **kwargs)
