from .debug import debuglog, set_debuglevel
from .probagen import generate_proba, make_proba_buffer
