"""Training of the port (automoe_tpu/train): the detection expert's
workload, optimizer, steps, loop and CLI (`automoe-train-torch`)."""
