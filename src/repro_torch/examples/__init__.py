"""Example drivers of the port, run as modules on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.serve_queries --governed
    PYTHONPATH=src python -m repro_torch.examples.rdf_scenario
    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200

Each prints what the reference's script of the same name
(``examples/*.py``) prints, and its functions return what they counted, so
a caller can hold the match counts to another run.
"""
