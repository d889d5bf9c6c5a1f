"""Language models, ported from ``repro.models``: the dense stack
(``layers``, ``attention``, ``transformer``, ``model``), which the vlm
and audio configs run on behind ``stubs``' frontend embeddings, the MoE
stack (``moe``), the zamba-style hybrid (Mamba2 blocks, ``ssm``, with a
shared attention block) and xLSTM (``xlstm``)."""
