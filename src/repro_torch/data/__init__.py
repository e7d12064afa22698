"""The token data pipeline of the PyTorch port: numpy only, the
reference's own file, so its batches equal the reference's bit for bit."""
