"""User-facing model handle (reference: band/model.h, band/interface/model.h:200-221)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

from ..tflite.parser import parse_tflite, parse_tflite_file
from .graph import Graph


@dataclass
class Model:
    graph: Graph
    path: str = ""
    model_id: int = -1

    @staticmethod
    def from_path(path: str) -> "Model":
        return Model(graph=parse_tflite_file(path), path=path)

    @staticmethod
    def from_buffer(data: bytes, name: str = "<buffer>") -> "Model":
        return Model(graph=parse_tflite(data), path=name)

    @property
    def name(self) -> str:
        return os.path.basename(self.path) if self.path else self.graph.name
