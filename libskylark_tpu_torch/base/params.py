"""Base parameter struct for all algorithms (the port's copy of
libskylark_tpu/base/params.py): logging knobs plus a JSON round trip, so
parameter sets written by either package load in the other."""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Any, TextIO


@dataclasses.dataclass
class Params:
    am_i_printing: bool = False
    log_level: int = 0
    debug_level: int = 0
    prefix: str = ""
    log_stream: TextIO = dataclasses.field(default=sys.stdout, repr=False)

    def log(self, level: int, message: str) -> None:
        if self.am_i_printing and self.log_level >= level:
            print(f"{self.prefix}{message}", file=self.log_stream)

    def to_dict(self) -> dict[str, Any]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "log_stream"}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, d: dict[str, Any]):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))
