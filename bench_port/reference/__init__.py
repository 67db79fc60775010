"""Plain PyTorch references of the benchmark's model families, one file a
family (``moe``, ``ssm``), with the pieces they share in ``plain``.  They
import neither JAX nor anything of the port, and read only the sizes of a
configuration file's ``model`` object, the benchmark's weights and
tokens."""
