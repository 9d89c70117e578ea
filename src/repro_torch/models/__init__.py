"""The model serving paths the port runs: two-tower retrieval
(``recsys/two_tower.py``) and the dense decoder-only LM
(``transformer/model.py``), on one device, with their cells
(``registry.py``)."""
