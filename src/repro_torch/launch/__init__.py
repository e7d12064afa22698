"""Entry points of the PyTorch port: the planner-serving CLI and the
report, the model-serving driver (``serve_model``) and the planner mesh."""
