"""regex_fpga_tpu — a JAX regex stream-matching framework.

A from-scratch JAX/XLA re-design of the capabilities of the FPGA
reference design ``linfenghuaster/Regex-FPGA`` (see SURVEY.md): CSR-encoded
automata loaded from the reference ``.coe`` memory images, a bit-exact NFA
bitset engine for the shipped intrusion-detection rulesets, and a
block-parallel speculative DFA scan engine (associative transition-function
composition) for high-throughput scanning, sharded over device meshes.
"""

__version__ = "0.1.0"
