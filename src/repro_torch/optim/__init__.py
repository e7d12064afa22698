"""The optimizer of the PyTorch port: AdamW with the reference's arithmetic
(``adamw``) and the int8 ring all-reduce over in-process replicas
(``compressed``)."""
