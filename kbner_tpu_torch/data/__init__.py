"""Host-side data: sentence records, tag dictionaries, subword encoding."""
from .subword import (HashTokenizer, HFTokenizer, SubwordTokenizer,
                      subtoken_length)

__all__ = ["HashTokenizer", "HFTokenizer", "SubwordTokenizer",
           "subtoken_length"]
