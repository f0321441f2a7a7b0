"""Phone sequences (port of `amphion_tpu/data/processors/phone.py`): g2p
every utterance with text, keep the symbol table stable across runs
(``symbols.dict``, read back when it exists), and write each utterance's
phone ids as ``phones/<uid>.json``."""

from __future__ import annotations

import json
from pathlib import Path

from amphion_tpu_torch.data.metadata import Utterance
from amphion_tpu_torch.text.g2p import G2PModule
from amphion_tpu_torch.text.symbol_table import SymbolTable


def extract_phone_sequences(utterances: list[Utterance], output_dir: str | Path,
                            backend: str = "char", lexicon_path: str | None = None,
                            symbol_table: SymbolTable | None = None) -> SymbolTable:
    out = Path(output_dir)
    (out / "phones").mkdir(parents=True, exist_ok=True)
    g2p = G2PModule(backend, lexicon_path)
    if symbol_table is None:
        table_path = out / "symbols.dict"
        if table_path.is_file():
            symbol_table = SymbolTable.from_file(table_path)
        else:
            symbol_table = g2p.build_symbol_table([u.text for u in utterances if u.text])
    for u in utterances:
        if not u.text:
            continue
        with open(out / "phones" / f"{u.uid}.json", "w") as f:
            json.dump(g2p.to_ids(u.text, symbol_table), f)
    symbol_table.to_file(out / "symbols.dict")
    return symbol_table
