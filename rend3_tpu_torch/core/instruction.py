"""Double-buffered instruction stream.

Reference: rend3/src/instruction.rs — the user-facing API pushes instructions
from any thread into a producer buffer; `swap_instruction_buffers` exchanges
producer/consumer at frame start and `evaluate_instructions` drains the
consumer. This decouples (thread-safe, any-time) scene mutation from
(once-per-frame, single-threaded) evaluation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from enum import Enum, auto
from typing import Any, List, Tuple

__all__ = ["InstructionKind", "Instruction", "InstructionStreamPair"]


class InstructionKind(Enum):
    ADD_SKELETON = auto()
    ADD_TEXTURE_2D = auto()
    ADD_TEXTURE_2D_FROM_TEXTURE = auto()
    ADD_TEXTURE_CUBE = auto()
    ADD_MATERIAL = auto()
    CHANGE_MATERIAL = auto()
    ADD_OBJECT = auto()
    SET_OBJECT_TRANSFORM = auto()
    SET_SKELETON_JOINT_DELTAS = auto()
    SET_SKELETON_JOINT_MATRICES = auto()
    ADD_DIRECTIONAL_LIGHT = auto()
    CHANGE_DIRECTIONAL_LIGHT = auto()
    ADD_POINT_LIGHT = auto()
    CHANGE_POINT_LIGHT = auto()
    SET_ASPECT_RATIO = auto()
    SET_CAMERA_DATA = auto()
    DUPLICATE_OBJECT = auto()
    DELETE_MESH = auto()
    DELETE_SKELETON = auto()
    DELETE_TEXTURE_2D = auto()
    DELETE_TEXTURE_CUBE = auto()
    DELETE_MATERIAL = auto()
    DELETE_OBJECT = auto()
    DELETE_DIRECTIONAL_LIGHT = auto()
    DELETE_POINT_LIGHT = auto()


@dataclass
class Instruction:
    kind: InstructionKind
    payload: Any


class InstructionStreamPair:
    def __init__(self):
        self._producer: List[Instruction] = []
        self._consumer: List[Instruction] = []
        self._lock = threading.Lock()

    def push(self, kind: InstructionKind, payload: Any) -> None:
        with self._lock:
            self._producer.append(Instruction(kind, payload))

    def swap(self) -> None:
        with self._lock:
            self._producer, self._consumer = self._consumer, self._producer

    def drain(self) -> List[Instruction]:
        with self._lock:
            out = self._consumer
            self._consumer = []
        return out
