"""The model substrate: configs' architectures as pure functions of their
parameters (``lm.LM``), dense family first."""
