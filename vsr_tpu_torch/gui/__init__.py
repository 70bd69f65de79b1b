"""Browser-based GUI for vsr_tpu_torch (a copy of ``vsr_tpu/gui``).

The reference ships a Qt desktop shell (gui.py:31, ui/home_interface.py:22,
ui/component/video_display_component.py, ui/setting_interface.py). PySide6
is not a dependency (and a desktop toolkit is a poor fit for a headless GPU
host), so the same behaviors are provided as a zero-dependency
local web app:

  * multi-file task queue with per-task status/progress and context actions
    (task_list_component.py:17-60)
  * preview canvas with draggable/resizable multi-rect subtitle-area
    selection, frame slider with AB-section markers, and preview<->video
    coordinate transforms (video_display_component.py:735-935)
  * live side-by-side original|inpainted preview during processing
    (home_interface.py:541-559)
  * settings panels: mode/detect/locale combos plus every RangeConfigItem
    slider (setting_interface.py:18-66, advanced_setting_interface.py:25-261)
  * severity-colored log pane (home_interface.py:514-539)

Process topology matches the reference: the HTTP server (the GUI process)
spawns ONE worker subprocess per task and talks to it over the
RemoteCallChannel queue (home_interface.py:409-470). The server process
touches no device; each worker resolves the one it was given (default
cuda) and names it in its first log line.

Run: ``python -m vsr_tpu_torch.gui [--port 8123] [--host 127.0.0.1]
[--device cuda]`` or ``python -m vsr_tpu_torch --gui``.
"""

from vsr_tpu_torch.gui.manager import GuiTaskManager
from vsr_tpu_torch.gui.server import GuiServer, main

__all__ = ["GuiTaskManager", "GuiServer", "main"]
