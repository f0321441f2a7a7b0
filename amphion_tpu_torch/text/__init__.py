from amphion_tpu_torch.text.cleaners import basic_cleaners, english_cleaners
from amphion_tpu_torch.text.g2p import G2PModule, LexiconG2P, intersperse
from amphion_tpu_torch.text.symbol_table import SymbolTable
from amphion_tpu_torch.text.symbols import SYMBOLS, symbols_to_ids
