/* CRC-16/CCITT over the 13-byte message "Automated TMR", the shape of the
 * reference's tests/crc16/crc16.c: a char pointer walked by *data_p++,
 * while (length--), unsigned char and unsigned short wraparound.  The CRC
 * of a fault-free run is 0x5BA3 (23459), the golden of
 * coast_tpu_torch/models/crc16.py. */
#include <stdio.h>

char *message = "Automated TMR";
unsigned short result = 0;

unsigned short crc16(char *data_p, unsigned short length) {
    unsigned char x;
    unsigned short crc = 0xFFFF;
    while (length--) {
        x = crc >> 8 ^ *data_p++;
        x ^= x >> 4;
        crc = (crc << 8) ^ ((unsigned short)(x << 12))
              ^ ((unsigned short)(x << 5)) ^ ((unsigned short)x);
    }
    return crc;
}

int main() {
    result = crc16(message, 13);
    printf("%u\n", result);
    return 0;
}
