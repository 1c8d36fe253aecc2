"""setup_s: seconds from the process's start to the window's first
request or step (loading, drawing the weights, building the kernels in a
first run, warming up; a training cell's first steps, which the check
follows, among them)."""


def read(rec):
    return rec["setup_s"]
