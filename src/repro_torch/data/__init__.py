from .synthetic import (PAPER_DATASETS, embedding_corpus,
                        embedding_corpus_with_holdout, paper_dataset,
                        paper_dataset_with_holdout, recsys_batch, token_batch,
                        train_test_split)

__all__ = ["PAPER_DATASETS", "embedding_corpus",
           "embedding_corpus_with_holdout", "paper_dataset",
           "paper_dataset_with_holdout", "recsys_batch", "token_batch",
           "train_test_split"]
