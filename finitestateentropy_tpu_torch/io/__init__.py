"""Host-side I/O: the compat codecs' frame layer (frame.py, the reference's
.fse frames) and resumable TurboRANS compression (jobs.py).
"""
