"""Target data objects.

The paper's runtime manages *target data objects* — arrays the programmer
registers with ``unimem_malloc``.  Here a :class:`DataObject` names a logical
array (or group of arrays, e.g. one transformer layer's weights, one KV-cache
block, one optimizer-state shard) whose tier residency the runtime controls.

Objects may be *chunkable* (paper §3.2 "Handling large data objects"): 1-D
regular arrays can be split into chunks that are placed independently.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class DataObject:
    """A managed data object.

    ``payload`` optionally binds a real JAX array (or pytree of arrays);
    simulation-only objects carry just ``size_bytes``.  ``leaf_spans``
    records the byte span of each pytree leaf inside the object
    (``(path, offset, nbytes)`` in flatten order) when the object was
    registered from a pytree — chunk attribution and partition boundaries
    can then align to leaf boundaries.
    """

    name: str
    size_bytes: int
    chunkable: bool = False
    payload: Any = None
    leaf_spans: Optional[List[Tuple[str, int, int]]] = None
    # Filled by partition.partition_object for chunks of a parent object.
    parent: Optional[str] = None
    chunk_index: Optional[int] = None
    # Current tier name, maintained by the mover / simulator.
    tier: str = "slow"
    pinned: bool = False   # pinned objects are never moved (e.g. SSM state)

    def __post_init__(self):
        if self.size_bytes < 0:
            raise ValueError(f"negative size for {self.name}")

    @property
    def is_chunk(self) -> bool:
        return self.parent is not None


class ObjectRegistry:
    """Registry of target data objects (the ``unimem_malloc`` table)."""

    def __init__(self) -> None:
        self._objs: Dict[str, DataObject] = {}
        # live chunk count per parent name: O(1) collision checks even at
        # thousands of registered chunks (the planner-scale regime)
        self._chunks_of: Dict[str, int] = {}
        #: chunk generation: bumped on every registration/removal, so plan
        #: provenance can record which registry shape produced a decision
        self.generation = 0

    def register(self, obj: DataObject) -> DataObject:
        if obj.name in self._objs:
            raise ValueError(
                f"duplicate data object {obj.name!r}: a registered object "
                "already holds this name (re-registering would orphan its "
                "tier and chunk state)")
        if self._chunks_of.get(obj.name, 0) > 0:
            example = next(o.name for o in self._objs.values()
                           if o.parent == obj.name)
            raise ValueError(
                f"duplicate data object {obj.name!r}: it was partitioned "
                f"and its chunks (e.g. {example!r}) are live; registering "
                "a new object under the parent name would orphan their "
                "chunk state")
        self.generation += 1
        self._objs[obj.name] = obj
        if obj.parent is not None:
            self._chunks_of[obj.parent] = \
                self._chunks_of.get(obj.parent, 0) + 1
        return obj

    def alloc(self, name: str, size_bytes: int, *, chunkable: bool = False,
              payload: Any = None, tier: str = "slow",
              pinned: bool = False) -> DataObject:
        return self.register(DataObject(
            name=name, size_bytes=size_bytes, chunkable=chunkable,
            payload=payload, tier=tier, pinned=pinned))

    def __getitem__(self, name: str) -> DataObject:
        return self._objs[name]

    def __contains__(self, name: str) -> bool:
        return name in self._objs

    def __iter__(self) -> Iterator[DataObject]:
        return iter(self._objs.values())

    def __len__(self) -> int:
        return len(self._objs)

    def names(self) -> List[str]:
        return list(self._objs.keys())

    def total_bytes(self) -> int:
        return sum(o.size_bytes for o in self._objs.values())

    def in_tier(self, tier: str) -> List[DataObject]:
        return [o for o in self._objs.values() if o.tier == tier]

    def bytes_in_tier(self, tier: str) -> int:
        return sum(o.size_bytes for o in self._objs.values() if o.tier == tier)

    def remove(self, name: str) -> None:
        self.generation += 1
        obj = self._objs.pop(name)
        if obj.parent is not None:
            left = self._chunks_of.get(obj.parent, 0) - 1
            if left > 0:
                self._chunks_of[obj.parent] = left
            else:
                self._chunks_of.pop(obj.parent, None)
