"""Device ms of one steady step of the job's own stepper (make_stepper),
by CUDA events over 20 steps queued behind a device spin."""


def read(rec):
    return rec.step_device_ms
