"""The LM stack's serving half: the ten architectures' blocks
(``layers``, ``ssm``), the model with its prefill and cached decode
(``model``), the configuration schema (``config``) and the carry-over of
the JAX package's parameter trees (``convert``)."""
