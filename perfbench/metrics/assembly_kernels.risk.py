"""Device operations a risk request launches besides kernel 1's primal and
forward-mode launches: the book plan's and the linearized assembly's
small kernels and copies, the stencil and theta epilogue, the Jacobian's
read-out and the columns' copy to the host."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    t = rec["trace"]
    ours = sum(t["kernel_launches"].get(k, 0)
               for k in ("kernel1", "kernel1_fwd"))
    return (t["device_ops"] - ours) / len(done) if done else None
