"""Grapheme-to-phoneme front end (port of `amphion_tpu/text/g2p.py`).

Backends:
- ``char``: cleaned characters as symbols (the served MaskGCT default,
  ``preprocess.g2p_backend`` in `config/base.json`);
- ``lexicon``: pronunciation-dictionary lookup (``WORD  PH1 PH2 ...``)
  with a letter-wise spelling fallback for words it does not hold;
- ``espeak`` needs the ``phonemizer`` package and raises without it, as
  JAX does; ``multilingual`` (the JAX package's own IPA tokenizer) is not
  ported and raises.

Both ported backends give the ids the JAX module gives.
"""

from __future__ import annotations

from pathlib import Path

from amphion_tpu_torch.text.cleaners import english_cleaners
from amphion_tpu_torch.text.symbol_table import SymbolTable


class LexiconG2P:
    def __init__(self, lexicon_path: str | Path):
        self.lexicon: dict[str, list[str]] = {}
        with open(lexicon_path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 2 and not parts[0].startswith(";;;"):
                    word = parts[0].upper().split("(")[0]
                    if word not in self.lexicon:
                        self.lexicon[word] = parts[1:]

    def __call__(self, text: str) -> list[str]:
        text = english_cleaners(text)
        phones: list[str] = []
        for word in text.split():
            w = word.strip("!'(),.:;?").upper()
            if not w:
                continue
            if w in self.lexicon:
                phones.extend("@" + p for p in self.lexicon[w])
            else:  # letter-wise spelling fallback
                for ch in w:
                    if ch in self.lexicon:
                        phones.extend("@" + p for p in self.lexicon[ch])
                    else:
                        phones.append(ch.lower())
            phones.append(" ")
        if phones and phones[-1] == " ":
            phones.pop()
        return phones


class G2PModule:
    """Dispatching front end over the backends above."""

    def __init__(self, backend: str = "char", lexicon_path: str | None = None,
                 language: str = "en-us"):
        self.backend = backend
        self.language = language
        if backend == "lexicon":
            if not lexicon_path:
                raise ValueError("the lexicon backend needs lexicon_path")
            self._lex = LexiconG2P(lexicon_path)
        elif backend == "multilingual":
            raise NotImplementedError("the multilingual g2p backend is not ported; "
                                      "use backend='char' or 'lexicon'")
        elif backend == "espeak":
            try:
                from phonemizer.backend import EspeakBackend  # optional
            except ImportError as e:
                raise ImportError("espeak backend requires the 'phonemizer' package; use "
                                  "backend='lexicon' or 'char' instead") from e
            self._espeak = EspeakBackend(language, preserve_punctuation=True,
                                         with_stress=True)

    def phonemes(self, text: str) -> list[str]:
        if self.backend == "lexicon":
            return self._lex(text)
        if self.backend == "espeak":
            out = self._espeak.phonemize([english_cleaners(text)], strip=True)
            return list(out[0])
        return list(english_cleaners(text))  # char backend

    def build_symbol_table(self, texts: list[str]) -> SymbolTable:
        table = SymbolTable.from_symbols(["_"])  # pad = 0
        for t in texts:
            for p in self.phonemes(t):
                table.add(p)
        return table

    def to_ids(self, text: str, table: SymbolTable) -> list[int]:
        return [table[p] for p in self.phonemes(text) if p in table]


def intersperse(ids: list[int], item: int = 0) -> list[int]:
    """[a, b] -> [item, a, item, b, item] (the ``add_blank`` layout)."""
    out = [item] * (2 * len(ids) + 1)
    out[1::2] = ids
    return out
