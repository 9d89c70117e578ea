from .synthetic import (PAPER_DATASETS, embedding_corpus, paper_dataset,
                        recsys_batch, token_batch, train_test_split)

__all__ = ["PAPER_DATASETS", "embedding_corpus", "paper_dataset",
           "recsys_batch", "token_batch", "train_test_split"]
