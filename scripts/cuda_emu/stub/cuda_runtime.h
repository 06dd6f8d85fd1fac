// stands in for the CUDA header of this name (see ../emu_core.h)
#include "../emu_core.h"
