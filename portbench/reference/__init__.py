"""The plain reference: the configurations' models in plain PyTorch, in
float32 with TF32 off (``precision="fp8"``, the control: every product's operands
rounded to float8 e4m3 first, and the gradients reaching them to e5m2). It imports nothing of the
program and takes nothing the program made: weights come from
``portbench.weights`` by name, inputs from the harness."""
