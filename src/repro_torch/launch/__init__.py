"""Entry points of the PyTorch port: the planner-serving CLI and the
report, model serving (``serve_model``), the trainer
(``train``) and its steps (``steps``), and the planner mesh."""
