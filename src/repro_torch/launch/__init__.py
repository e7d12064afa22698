"""Entry points of the PyTorch port: the planner-serving CLI and the report."""
