from .pipeline import (CharTokenizer, classification_batches,  # noqa: F401
                       lm_batches, synthetic_text)
