"""Model families of the port: ``transformer`` (dense) and ``ssm``
(Mamba2), their shared ``layers``, the ``config`` and the family
``registry``."""
