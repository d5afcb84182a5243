"""Binary IDs with lineage-encoded ObjectIDs.

Reference semantics: src/ray/common/id.h — JobID (4 bytes), ActorID
(JobID + 12 random bytes), TaskID (ActorID + 8 bytes), ObjectID
(TaskID + 4-byte index), NodeID / WorkerID / PlacementGroupID (random 28B).
The key property preserved here is that an ObjectID embeds the TaskID that
created it (lineage), and a TaskID embeds the ActorID/JobID it belongs to —
this is what makes lineage reconstruction and ownership routing possible
without a global lookup.
"""

from __future__ import annotations

import os
import threading

_JOB_ID_SIZE = 4
_ACTOR_UNIQUE_BYTES = 12
_TASK_UNIQUE_BYTES = 8
_OBJECT_INDEX_BYTES = 4

ACTOR_ID_SIZE = _JOB_ID_SIZE + _ACTOR_UNIQUE_BYTES            # 16
TASK_ID_SIZE = ACTOR_ID_SIZE + _TASK_UNIQUE_BYTES             # 24
OBJECT_ID_SIZE = TASK_ID_SIZE + _OBJECT_INDEX_BYTES           # 28
UNIQUE_ID_SIZE = 28


class BaseID:
    """Immutable binary identifier."""

    SIZE = UNIQUE_ID_SIZE
    __slots__ = ("_binary", "_hash")

    def __init__(self, binary: bytes):
        if not isinstance(binary, bytes) or len(binary) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got "
                f"{len(binary) if isinstance(binary, bytes) else type(binary)}"
            )
        object.__setattr__(self, "_binary", binary)
        object.__setattr__(self, "_hash", hash((type(self).__name__, binary)))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._binary == b"\xff" * self.SIZE

    def binary(self) -> bytes:
        return self._binary

    def hex(self) -> str:
        return self._binary.hex()

    def __setattr__(self, *a):
        raise AttributeError(f"{type(self).__name__} is immutable")

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(self) is type(other) and self._binary == other._binary

    def __lt__(self, other):
        return self._binary < other._binary

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]}…)"

    def __reduce__(self):
        return (type(self), (self._binary,))


class UniqueID(BaseID):
    SIZE = UNIQUE_ID_SIZE


class NodeID(BaseID):
    SIZE = UNIQUE_ID_SIZE


class WorkerID(BaseID):
    SIZE = UNIQUE_ID_SIZE


class PlacementGroupID(BaseID):
    SIZE = UNIQUE_ID_SIZE


class JobID(BaseID):
    SIZE = _JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(_JOB_ID_SIZE, "little"))

    def int_value(self) -> int:
        return int.from_bytes(self._binary, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + os.urandom(_ACTOR_UNIQUE_BYTES))

    @classmethod
    def nil_for_job(cls, job_id: JobID) -> "ActorID":
        # The "no actor" actor id for a job: job bytes + 0xff padding.
        return cls(job_id.binary() + b"\xff" * _ACTOR_UNIQUE_BYTES)

    def job_id(self) -> JobID:
        return JobID(self._binary[:_JOB_ID_SIZE])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def for_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + os.urandom(_TASK_UNIQUE_BYTES))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        # The driver's implicit root task: nil actor, zero unique bytes.
        return cls(
            ActorID.nil_for_job(job_id).binary() + b"\x00" * _TASK_UNIQUE_BYTES
        )

    def actor_id(self) -> ActorID:
        return ActorID(self._binary[:ACTOR_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._binary[:_JOB_ID_SIZE])


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def for_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        """Lineage encoding: the creating task's id + return index."""
        if index < 0 or index >= 2 ** (_OBJECT_INDEX_BYTES * 8):
            raise ValueError(f"return index out of range: {index}")
        return cls(task_id.binary() + index.to_bytes(_OBJECT_INDEX_BYTES, "little"))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Puts share the index space with returns, offset into the top half
        # (reference: id.h ObjectID::FromIndex with put vs return bit).
        return cls.for_return(task_id, 2 ** (_OBJECT_INDEX_BYTES * 8 - 1) + put_index)

    def task_id(self) -> TaskID:
        return TaskID(self._binary[:TASK_ID_SIZE])

    def job_id(self) -> JobID:
        return JobID(self._binary[:_JOB_ID_SIZE])

    def return_index(self) -> int:
        return int.from_bytes(self._binary[TASK_ID_SIZE:], "little")

    def is_put(self) -> bool:
        return self.return_index() >= 2 ** (_OBJECT_INDEX_BYTES * 8 - 1)


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
