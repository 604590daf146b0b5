"""Training runtime of the port: AdamW, int8 gradient compression with error
feedback, framework-free checkpoints and the fault-tolerant trainer."""
