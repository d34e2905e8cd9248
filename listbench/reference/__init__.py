"""The plain reference the benchmark judges the port against: plain PyTorch
in float32 (``model``, ``index``, ``score``) and its lower-precision
control (``control``). It reads only the benchmark's inputs, never the
port or anything the port made."""
