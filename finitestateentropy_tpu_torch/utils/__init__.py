from .debug import debuglog, set_debuglevel
from .probagen import generate_proba, make_proba_buffer
from .xxhash32 import xxh32
from .xxhash64 import xxh64
