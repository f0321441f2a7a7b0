"""k2-style symbol table (reference: `utils/symbol_table.py`,
`text/text_token_collation.py`): bidirectional symbol<->id mapping with
file persistence, used to keep phone vocabularies stable across runs.

The port's own copy of `amphion_tpu/text/symbol_table.py`.
"""

from __future__ import annotations

from pathlib import Path


class SymbolTable:
    def __init__(self, sym2id: dict[str, int] | None = None):
        self._sym2id: dict[str, int] = dict(sym2id or {})
        self._id2sym: dict[int, str] = {v: k for k, v in self._sym2id.items()}

    @classmethod
    def from_symbols(cls, symbols: list[str]) -> "SymbolTable":
        return cls({s: i for i, s in enumerate(symbols)})

    def add(self, symbol: str) -> int:
        if symbol in self._sym2id:
            return self._sym2id[symbol]
        idx = len(self._sym2id)
        while idx in self._id2sym:
            idx += 1
        self._sym2id[symbol] = idx
        self._id2sym[idx] = symbol
        return idx

    def get(self, symbol: str) -> int:
        return self._sym2id[symbol]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._sym2id[key]
        return self._id2sym[key]

    def __contains__(self, symbol: str) -> bool:
        return symbol in self._sym2id

    def __len__(self) -> int:
        return len(self._sym2id)

    @property
    def symbols(self) -> list[str]:
        return [self._id2sym[i] for i in sorted(self._id2sym)]

    def to_file(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for sym, idx in sorted(self._sym2id.items(), key=lambda kv: kv[1]):
                f.write(f"{sym} {idx}\n")

    @classmethod
    def from_file(cls, path: str | Path) -> "SymbolTable":
        sym2id = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split()
                if len(parts) == 2:
                    sym2id[parts[0]] = int(parts[1])
                elif len(parts) == 1 and line.startswith(" "):
                    sym2id[" "] = int(parts[0])
        return cls(sym2id)
