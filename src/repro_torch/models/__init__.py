"""The model substrate of the PyTorch port: configs, layers, the dense
decoder and the weight converter from the reference."""
