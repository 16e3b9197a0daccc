"""The model substrate: configs' architectures as pure functions of their
parameters (``lm.LM``): the dense, vlm, MoE (GQA or MLA, ``moe``) and ssm
families."""
